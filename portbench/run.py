"""Run one benchmark cell and print its result as the last line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Everything particular to a cell is found
by name: the cell's entry in BENCHMARK.json names its configuration
(``portbench/configs/<config>.json``) and its traffic mix
(``portbench/traffic/<traffic>.json``, whose ``kind`` names the
generator ``portbench/traffic/<kind>.py``); each metric the cell
reports is read by ``portbench/metrics/<metric>.py``. A run:

1. builds the cell from the seed (the generator's ``build``: weights
   drawn on the device and loaded through the program's own converters,
   the traffic's inputs) and warms its shapes: the set-up, ``setup_s``;
2. runs the generator's steps, a closed loop, until ``--seconds`` have
   passed; with ``--trace 1`` under torch.profiler (device activity);
3. reads the device's peak memory, frees the program, and checks what
   the window produced against the plain reference
   (``portbench/reference``), printing each compared number beside its
   limit on standard error;
4. prints one JSON line: ``correct``, ``attempted``, ``failed``,
   ``metrics`` (the cell's end-to-end metrics with ``--trace 0``, its
   per-layer ones with ``--trace 1``), ``device``, ``breakdown`` when
   traced, and ``checks`` last.

It exits with another code than 0, and prints no result, without CUDA
or with fewer cards than the cell asks for, and when JAX or the JAX
package is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import sys
import time
from typing import List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "video_llava_tpu")


def process_start() -> float:
    """time.monotonic() at which this process started (from /proc),
    else now."""
    now = time.monotonic()
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return now - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return now


_START = process_start()


def cache_dirs() -> None:
    """Keep the kernel caches at fixed paths inside the checkout (the
    program's own library is built into video_llava_tpu_torch/build)."""
    base = os.path.join(HERE, ".cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base,
                                                      "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_file_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The reader of a metric: portbench/metrics/<metric>.py."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    return load_file_module(path, "portbench_metric_" + metric.replace(
        ".", "_").replace("-", "_"))


def cell_metrics(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a cell reports: its end-to-end ones untraced, its
    per-layer ones traced (a metric without ``workloads`` is reported
    wherever the metric it moves is)."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}

    def reported(m):
        return (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)

    return [m for m in bench["per_layer"] if reported(m)]


@dataclasses.dataclass
class Run:
    """What a window left for the metric readers: the cell's
    configuration and mix as run, and each step's record, which holds
    the step's shapes (a reader counts operations and bytes from them
    with portbench/flops.py), its host-clock times and its outcome."""

    setup_s: float
    window_s: float
    records: List[dict]
    cfg: dict
    mix: dict
    trace: Optional[dict] = None


def forbidden_modules() -> List[str]:
    return sorted(n for n in list(sys.modules)
                  if n.split(".")[0] in FORBIDDEN)


def run_cell(cfg: dict, mix: dict, metrics: List[dict], seed: int,
             seconds: float, trace: bool, device, start: float,
             control: bool = False) -> dict:
    """Build, warm, measure and check one cell; return the result line's
    object (``device`` filled by the caller). With `control`, the
    control takes the program's place: the mix's ``control`` overrides
    (a program path of lower precision) where it has them, and the
    check judges the control's answers by the same limits."""
    import torch

    from portbench.trace import Window, summarize

    if control:
        mix = {**mix, **mix.get("control", {})}
    gen = importlib.import_module("portbench.traffic." + mix["kind"])
    cellobj = gen.build(cfg, mix, seed, device)
    cellobj.warm()
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.monotonic() - start
    records: List[dict] = []
    with Window(trace, device.type == "cuda") as w:
        t_end = w.perf0 + int(seconds * 1e9)
        k = 0
        while time.perf_counter_ns() < t_end:
            records.append(cellobj.step(k))
            k += 1
        if device.type == "cuda":
            torch.cuda.synchronize()
    summary = None
    if trace:
        spans = [s for r in records for s in r["spans"]]
        summary = summarize(w.device_events(), spans, w.perf0, w.perf1)
        summary["window_s"] = w.seconds
    peak = (max(torch.cuda.max_memory_allocated(i)
                for i in range(torch.cuda.device_count()))
            if device.type == "cuda" else 0)
    cellobj.free()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.monotonic()
    verdict = cellobj.check(records, control=control)
    check_s = time.monotonic() - t_check
    run = Run(setup_s, w.seconds, records, cfg, mix, summary)
    values = {}
    for m in metrics:
        v = reader(m["name"]).read(run)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {"correct": verdict["correct"],
           "attempted": sum(r["attempted"] for r in records),
           "failed": sum(r["failed"] for r in records),
           "metrics": values,
           "device": {"memory_peak_bytes": peak}}
    if summary is not None:
        out["device"].update(busy_s=summary["busy_s"],
                             window_s=summary["window_s"])
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
    out["check_s"] = check_s
    for key in ("program", "detail"):
        if key in verdict:
            out[key] = verdict[key]
    out["checks"] = verdict["checks"]
    return out


def resolve(cell: str, bench_path: str):
    """(bench, entry, cfg, mix) of a cell named in BENCHMARK.json."""
    bench = load_json(bench_path)
    entries = {w["name"]: w for w in bench["workloads"]}
    if cell not in entries:
        raise SystemExit(f"unknown workload {cell!r}; BENCHMARK.json has "
                         f"{sorted(entries)}")
    entry = entries[cell]
    cfg = load_json(HERE, "configs", entry["config"] + ".json")
    mix = load_json(HERE, "traffic", entry["traffic"] + ".json")
    return bench, entry, cfg, mix


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    cache_dirs()
    bench, entry, cfg, mix = resolve(args.workload,
                                     os.path.join(ROOT, "BENCHMARK.json"))
    import torch

    chips = int(entry["chips"])
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < chips:
        print(f"portbench: the cell asks for {chips} CUDA card(s); {cards} "
              f"available", file=sys.stderr)
        return 2
    metrics = cell_metrics(bench, args.workload, bool(args.trace))
    out = run_cell(cfg, mix, metrics, args.seed, args.seconds,
                   bool(args.trace), torch.device("cuda", 0), _START)
    out["device"] = {"platform": "gpu",
                     "kind": torch.cuda.get_device_name(0),
                     "count": chips, **out["device"]}
    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: JAX or the JAX package is loaded: {loaded}",
              file=sys.stderr)
        return 3
    checks = out["checks"]
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
