"""Kernels 7 and 8 (csrc/flash_attention.cu: the causal forward, run
twice a layer under recomputation, and the backward's dq and dk/dv):
the window's summed bounds of their calls over their device time in the
trace, as a percentage. A training step calls each once a decoder layer
over the padded batch (portbench/flops.flash_calls), the forward
twice."""

from portbench import flops
from portbench.trace import device_seconds

KERNELS = (r"\bfwd_kernel\b", r"\bdq_kernel\b", r"\bdkv_kernel\b")
CALLS = (("fwd", 2), ("dq", 1), ("dkv", 1))  # calls a layer a step


def step_bound(cfg: dict, rows: int, s_pad: int) -> float:
    """Bound seconds of one step's calls over `rows` rows of `s_pad`."""
    calls = flops.flash_calls(rows, s_pad, cfg["num_attention_heads"],
                              cfg["num_key_value_heads"], cfg["head_dim"])
    layer = sum(k * flops.bound_s(*calls[name], "bf16") for name, k in CALLS)
    return cfg["num_hidden_layers"] * layer


def read(run):
    if run.trace is None:
        return None
    bound = sum(step_bound(run.cfg, r["rows"], r["s_pad"])
                for r in run.records if r["kind"] == "train")
    busy = device_seconds(run.trace["by_name"], KERNELS)
    if busy <= 0 or bound <= 0:
        return None
    return 100.0 * bound / busy
