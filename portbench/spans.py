"""A benchmark cell read through the program's own spans.

    python3 -m portbench.spans --workload <cell> --seed <n> --seconds <s>
    python3 -m portbench.spans --workload <cell> --seed <n> --seconds <s> \
        --oncost <windows>

from the root of a checkout, on the card. It builds and warms the cell
as ``portbench.run`` does, turns on the program's span recorder
(video_llava_tpu_torch/utils/trace_tools), opens each step's span
through it (so a batch's program spans have it as their parent) and
runs one window under torch.profiler. It prints one JSON line:

- for a QA cell, utils/trace_tools.decode_report of the window's
  ``generate.prefill`` / ``generate.decode_step`` spans against the
  device's activities (``prefill_ms``, ``decode_step_ms``,
  ``decode_idle_share``, ``decode_ops_per_step``, ``max_gap_us``, and
  ``inside_share``: the activities that start inside the harness's
  ``engine.generate_tokens`` span and lie inside one program span), with
  ``remainder_ms`` (each batch's ``engine.generate_tokens`` less its
  program spans: the harness's copy of the tokens) and ``bad_batches``
  (batches whose spans are not one prefill and answer - 1 steps);
- for the training cell, each ``train.*`` span's mean host time;
- ``idle_named``: the device's idle seconds, gaps and longest gap under
  the innermost span open at each gap's midpoint
  (utils/trace_tools.idle_by_span), beside ``idle_harness``, the
  accepted naming (portbench/trace.summarize: the harness's spans);
- ``accepted``: the cell's accepted metrics read from the same window.

The train spans mark the host's place, not device time per phase.

With ``--oncost N`` it runs N untraced windows instead, the recorder on
in every other pair (off, on, on, off, ...), and prints each window's
``qa_per_min`` (or ``train_tok_s``) and the medians with the recorder
on and off: what the recorder costs with the profiler off.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import statistics
import sys
import time

from portbench import run as prun
from portbench.trace import Window, summarize

ROOT = prun.ROOT


def build(cfg: dict, mix: dict, seed: int, device):
    """The cell built and warmed, as portbench.run builds it."""
    import torch

    gen = importlib.import_module("portbench.traffic." + mix["kind"])
    cell = gen.build(cfg, mix, seed, device)
    cell.warm()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return cell


def window(cell, seconds: float, traced: bool, recorder: bool, device):
    """One closed-loop window, each step inside a recorder span named
    ``harness.step``; (Window, records, the drained spans)."""
    import torch

    from video_llava_tpu_torch.utils import trace_tools

    trace_tools.drain()
    trace_tools.enable(recorder)
    records = []
    try:
        with Window(traced, device.type == "cuda") as w:
            t_end = w.perf0 + int(seconds * 1e9)
            k = 0
            while time.perf_counter_ns() < t_end:
                sp = trace_tools.begin("harness.step")
                records.append(cell.step(k))
                trace_tools.end(sp)
                k += 1
            if device.type == "cuda":
                torch.cuda.synchronize()
    finally:
        trace_tools.enable(False)
    return w, records, trace_tools.drain()


def qa_report(records, spans, events) -> dict:
    """decode_report of the window's generate calls, each against its
    batch's ``engine.generate_tokens`` span, with the remainders."""
    from video_llava_tpu_torch.utils import trace_tools

    calls = trace_tools.generate_calls(spans)
    qa = [r for r in records if r["kind"] == "qa"]
    gen = [next(s for s in r["spans"] if s[0] == "engine.generate_tokens")
           for r in qa]
    good, windows, bad, remainder, covered = [], [], [], [], []
    for r, (_, g0, g1) in zip(qa, gen):
        mine = [c for c in calls if g0 <= c[0].start_ns < g1]
        names = [s.name for c in mine for s in c]
        if names != ["generate.prefill"] + ["generate.decode_step"] * (
                r["answer_len"] - 1) or mine[0][-1].end_ns > g1:
            bad.append(names[:2] + [len(names)])
            continue
        good.append(mine[0])
        windows.append((g0, g1))
        inside = sum(s.end_ns - s.start_ns for s in mine[0])
        remainder.append((g1 - g0 - inside) / 1e6)
        covered.append(inside / (g1 - g0))
    out = trace_tools.decode_report(good, events, windows)
    out.update(batches=len(qa), calls=len(calls), bad_batches=bad)
    if remainder:
        out.update(remainder_ms=[statistics.fmean(remainder),
                                 min(remainder), max(remainder)],
                   covered_share=[min(covered), max(covered)])
    return out


def named(idle: dict, top: int = 8) -> list:
    return [[n, v[0], int(v[1]), v[2]]
            for n, v in sorted(idle.items(), key=lambda kv: -kv[1][0])[:top]]


def traced(bench, name, cfg, mix, seed, seconds, device) -> dict:
    import torch

    from video_llava_tpu_torch.utils import trace_tools

    start = time.monotonic()
    cell = build(cfg, mix, seed, device)
    setup_s = time.monotonic() - start
    w, records, spans = window(cell, seconds, True, True, device)
    events = w.device_events()
    harness = [s for r in records for s in r["spans"]]
    summary = summarize(events, harness, w.perf0, w.perf1)
    summary["window_s"] = w.seconds
    run = prun.Run(setup_s, w.seconds, records, cfg, mix, summary)
    accepted = {}
    for m in (prun.cell_metrics(bench, name, True)
              + prun.cell_metrics(bench, name, False)):
        if m["name"] != "setup_s":
            accepted[m["name"]] = prun.reader(m["name"]).read(run)
    program = [s for s in spans if s.name != "harness.step"]
    as_spans = [trace_tools.Span(n, s, e, -1, None) for n, s, e in harness]
    names = {s.id: s.name for s in spans}
    out = {"cell": name, "seed": seed, "window_s": w.seconds,
           "setup_s": setup_s, "window_steps": len(records),
           "spans": len(program), "activities": len(events),
           "parents": sorted({(s.name, names.get(s.parent))
                              for s in program}),
           "accepted": accepted,
           "idle_harness": summary["idle_gaps"],
           "idle_named": named(trace_tools.idle_by_span(
               events, as_spans + program, w.perf0, w.perf1))}
    if any(r["kind"] == "qa" for r in records):
        out.update(qa_report(records, program, events))
    else:
        by = {}
        for s in program:
            by.setdefault(s.name, []).append((s.end_ns - s.start_ns) / 1e6)
        out["span_ms"] = {n: [statistics.fmean(v), len(v)]
                          for n, v in sorted(by.items())}
    out["device"] = (torch.cuda.get_device_name(0)
                     if device.type == "cuda" else "cpu")
    cell.free()
    return out


def oncost(cfg, mix, seed, seconds, windows, device) -> dict:
    """`windows` untraced windows, the recorder on in every other pair."""
    cell = build(cfg, mix, seed, device)
    metric = "train_tok_s" if mix["kind"] == "train_projector" else (
        "qa_per_min")
    read = prun.reader(metric).read
    rows = []
    for k in range(windows):
        on = k % 4 in (1, 2)
        w, records, spans = window(cell, seconds, False, on, device)
        rows.append({"recorder": on, metric: read(prun.Run(
            0.0, w.seconds, records, cfg, mix)), "spans": len(spans),
            "steps": len(records)})
        print(json.dumps(rows[-1]), file=sys.stderr, flush=True)
    cell.free()
    med = {side: statistics.median(r[metric] for r in rows
                                   if r["recorder"] == side)
           for side in (True, False) if any(r["recorder"] == side
                                            for r in rows)}
    return {"metric": metric, "rows": rows, "on_median": med.get(True),
            "off_median": med.get(False)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--oncost", type=int, default=0,
                   help="this many untraced windows, recorder on and off")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    prun.cache_dirs()
    import torch

    bench, _, cfg, mix = prun.resolve(
        args.workload, os.path.join(ROOT, "BENCHMARK.json"))
    device = torch.device(args.device)
    if args.oncost:
        out = oncost(cfg, mix, args.seed, args.seconds, args.oncost, device)
        out.update(cell=args.workload, seed=args.seed)
    else:
        out = traced(bench, args.workload, cfg, mix, args.seed,
                     args.seconds, device)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
