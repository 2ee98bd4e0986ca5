"""The window's model operations (portbench/flops.qa_batch_ops from each
batch's shapes) at each number format's dense peak (bf16 989 TFLOP/s,
int8 1,979 TOP/s, f32 67 TFLOP/s), as a percentage of the window."""

from portbench import flops


def read(run):
    qa = [r for r in run.records if r["kind"] == "qa"]
    if not qa:
        return None
    ops = {}
    for r in qa:
        flops.add(ops, flops.qa_batch_ops(run.cfg, r["frames"],
                                          r["prompt_lens"], r["answer_len"]))
    return 100.0 * flops.peak_seconds(ops) / run.window_s
