"""Kernel 1 (csrc/flash_bhsd.cu, the CLIP tower's attention): the
window's summed bounds of its calls over its device time in the trace,
as a percentage. A QA batch calls it once a tower layer up to the
penultimate (the features' layer) over every frame's heads: queries at
the tower's padded length, keys at the real tokens
(portbench/flops.clip_attn_call)."""

from portbench import flops
from portbench.trace import device_seconds

KERNELS = (r"\bbhsd_kernel\b",)


def batch_bound(v: dict, frames: int) -> float:
    """Bound seconds of one batch's calls over `frames` frames, for the
    configuration's vision tower `v`."""
    d, heads = v["hidden_size"], v["num_attention_heads"]
    n = (v["image_size"] // v["patch_size"]) ** 2 + 1
    nbytes, ops = flops.clip_attn_call(frames * heads,
                                       flops.clip_padded_length(n), n,
                                       d // heads)
    return (v["num_hidden_layers"] - 1) * flops.bound_s(nbytes, ops, "bf16")


def read(run):
    if run.trace is None:
        return None
    v = run.cfg["vision_config"]
    bound = sum(batch_bound(v, r["batch"] * r["frames"])
                for r in run.records if r["kind"] == "qa")
    busy = device_seconds(run.trace["by_name"], KERNELS)
    if busy <= 0 or bound <= 0:
        return None
    return 100.0 * bound / busy
