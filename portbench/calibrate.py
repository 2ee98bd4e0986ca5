"""Read a cell's check on several seeds in one process, with its control.

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3 \
        --seconds 8 [--control] [--fault half_batch]

For each seed: the cell's set-up, a window of --seconds at the cell's
own load, and the check. With --control, the control's verdict and
readings too, the control judged in the program's place by the same
limits: where the mix names a program path of lower precision (its
``control`` overrides, such as a frozen int8 LLM), the cell again with
that path on; else the reference one precision step lower
(reference/model.CONTROL), whose answers the check judges beside the
program's over the same window. With --fault, the cell again with the
named fault planted in the program (FAULTS). The benchmark's own runs never compute these. One JSON line a
seed; the limits in portbench/traffic/<mix>.json are set from these
readings (PERF.md gives them).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys
import time

from portbench import run


@contextlib.contextmanager
def half_batch():
    """The training step's loss over the first half of the batch's rows
    only, the mean taken over them."""
    from video_llava_tpu_torch.train import train_step

    real = train_step.loss_fn

    def half(model, batch):
        h = batch["input_ids"].shape[0] // 2
        return real(model, {k: v[:h] for k, v in batch.items()})

    train_step.loss_fn = half
    try:
        yield
    finally:
        train_step.loss_fn = real


FAULTS = {"half_batch": half_batch}


def readings(out: dict) -> dict:
    return {k: v["value"] for k, v in out["checks"].items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", choices=sorted(FAULTS))
    args = p.parse_args(argv)
    run.cache_dirs()
    bench, _, cfg, mix = run.resolve(
        args.workload, os.path.join(run.ROOT, "BENCHMARK.json"))
    import torch

    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    metrics = run.cell_metrics(bench, args.workload, False)

    def once(seed, m, control=False):
        out = run.run_cell(cfg, m, metrics, seed, args.seconds, False, dev,
                           time.monotonic(), control=control)
        gc.collect()
        torch.cuda.empty_cache()
        return out

    for seed in (int(s) for s in args.seeds.split(",")):
        out = once(seed, mix, control=args.control)
        judged = {"program": out}
        if args.control:
            judged["control"] = out
            if "program" in out:  # the window ran the program; both judged
                judged["program"] = out["program"]
            else:  # a program path of lower precision: its own run
                out = judged["program"] = once(seed, mix)
        prog = judged["program"]
        line = {"seed": seed, "correct": prog["correct"],
                "program": readings(prog), "attempted": out["attempted"],
                "memory_peak_bytes": out["device"]["memory_peak_bytes"],
                "check_s": out["check_s"],
                "metrics": {k: v["value"] for k, v in out["metrics"].items()}}
        if "detail" in prog:
            line["detail"] = prog["detail"]
        if args.control:
            low = judged["control"]
            line["control_correct"] = low["correct"]
            line["control"] = readings(low)
            line["control_detail"] = low.get("detail")
        if args.fault:
            with FAULTS[args.fault]():
                bad = once(seed, mix)
            line["fault_correct"] = bad["correct"]
            line["fault"] = readings(bad)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
