"""Kernel B (csrc/w4a8_block.cu: the activation quantize and the
int8 wgmma product, the prefill's int4 linears): the window's summed
bounds of its calls over its device time in the trace, as a
percentage. A QA batch's prefill calls it once a linear of each decoder
layer over the batch's padded prompt rows
(portbench/flops.w4a8_block_call)."""

from portbench import flops
from portbench.trace import device_seconds

KERNELS = (r"\bw4a8_block_kernel\b", r"\bquantize_rows_kernel\b")


def batch_bound(cfg: dict, rows: int) -> float:
    """Bound seconds of one prefill's calls over `rows` padded rows."""
    layer = sum(flops.bound_s(*flops.w4a8_block_call(rows, d_in, f), "int8")
                for d_in, f in flops.llm_linears(cfg).values())
    return cfg["num_hidden_layers"] * layer


def read(run):
    if run.trace is None:
        return None
    bound = sum(batch_bound(run.cfg, r["batch"] * r["s_pad"])
                for r in run.records if r["kind"] == "qa")
    busy = device_seconds(run.trace["by_name"], KERNELS)
    if busy <= 0 or bound <= 0:
        return None
    return 100.0 * bound / busy
