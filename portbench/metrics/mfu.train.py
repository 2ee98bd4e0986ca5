"""The window's training operations (portbench/flops.train_step_ops
from each step's shapes: the forward and the input gradients, not the
recomputation) at each number format's dense peak, as a percentage of
the window."""

from portbench import flops


def read(run):
    steps = [r for r in run.records if r["kind"] == "train"]
    if not steps:
        return None
    ops = {}
    for r in steps:
        flops.add(ops, flops.train_step_ops(run.cfg, r["lens"],
                                            r["targets"]))
    return 100.0 * flops.peak_seconds(ops) / run.window_s
