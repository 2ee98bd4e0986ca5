"""torch.profiler trace parsing: aggregate device op times.

Counterpart of video_llava_tpu/utils/trace_tools.py. The port's traces
are torch.profiler chrome traces: `prof.export_chrome_trace(path)`, or
the `*.pt.trace.json[.gz]` files that
`torch.profiler.tensorboard_trace_handler(dir)` writes. This module reads
one back and sums the complete ('X') events of the device's activity
(kernels, copies, memsets) by name, so a profile decomposes without
TensorBoard. A trace without device activity (a CPU run) falls back to
every complete event, as the JAX reader falls back to every track.

Run: python -m video_llava_tpu_torch.utils.trace_tools TRACE_DIR [N]
"""

from __future__ import annotations

import collections
import glob
import gzip
import json
import os
from typing import Dict, Iterable, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class OpTotals(list):
    """[(op_name, total_ms, count)] sorted by total time, with `source`:
    'device' (only device activity was read) or 'all' (the trace held
    none, and every complete event was read)."""

    def __init__(self, rows, source: str):
        super().__init__(rows)
        self.source = source


def find_trace_file(trace_dir: str) -> str:
    """The newest *.json or *.json.gz under `trace_dir` (recursively), or
    `trace_dir` itself when it is a file."""
    if os.path.isfile(trace_dir):
        return trace_dir
    files: List[str] = []
    for pat in ("*.json", "*.json.gz"):
        files += glob.glob(os.path.join(trace_dir, "**", pat),
                           recursive=True)
    if not files:
        raise FileNotFoundError(f"no trace files under {trace_dir}")
    return max(files, key=os.path.getmtime)


def load_trace_events(path: str) -> List[dict]:
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rt") as f:
        data = json.load(f)
    return data.get("traceEvents", []) if isinstance(data, dict) else data


def device_op_totals(trace_dir: str,
                     include_substr: Optional[str] = None) -> OpTotals:
    """-> OpTotals [(op_name, total_ms, count)] sorted by total time, of
    the complete ('X') events whose `cat` is kernel, gpu_memcpy or
    gpu_memset; of every complete event when the trace has none of those
    (`source` says which). `include_substr` keeps names containing it."""
    events = [e for e in load_trace_events(find_trace_file(trace_dir))
              if e.get("ph") == "X"]
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    source = "device" if device else "all"
    totals: Dict[str, float] = collections.defaultdict(float)
    counts: Dict[str, int] = collections.defaultdict(int)
    for e in device or events:
        name = e.get("name", "")
        if include_substr and include_substr not in name:
            continue
        totals[name] += e.get("dur", 0) / 1e3  # us -> ms
        counts[name] += 1
    return OpTotals(sorted(((k, v, counts[k]) for k, v in totals.items()),
                           key=lambda t: -t[1]), source)


def print_rows(rows: OpTotals, n: int = 30) -> None:
    """The top `n` rows of an OpTotals, after a line with their count and
    total."""
    total = sum(r[1] for r in rows)
    print(f"# {len(rows)} distinct ops, {total:.1f} ms total "
          f"{'device' if rows.source == 'device' else 'event'} time")
    for name, ms, cnt in rows[:n]:
        print(f"{ms:9.2f} ms  x{cnt:<6} {name[:110]}")


def print_top_ops(trace_dir: str, n: int = 30, **kw) -> None:
    print_rows(device_op_totals(trace_dir, **kw), n)


def span_totals(spans: Iterable[Tuple[str, float, float]],
                source: str = "device") -> OpTotals:
    """(name, start ns, end ns) spans (a profiler's events read in
    memory, without a chrome trace) -> OpTotals by total time."""
    totals: Dict[str, float] = collections.defaultdict(float)
    counts: Dict[str, int] = collections.defaultdict(int)
    for name, start, stop in spans:
        totals[name] += (stop - start) / 1e6  # ns -> ms
        counts[name] += 1
    return OpTotals(sorted(((k, v, counts[k]) for k, v in totals.items()),
                           key=lambda t: -t[1]), source)


def busy_and_names(spans: Iterable[Tuple[str, float, float]]):
    """(name, start ns, end ns) of device activities -> (busy ms: the
    length of the union of their intervals, {name: (total us, calls)})."""
    busy_ns, end = 0.0, float("-inf")
    by_name: dict = {}
    for name, start, stop in sorted(spans, key=lambda s: s[1]):
        busy_ns += max(0.0, stop - max(start, end))
        end = max(end, stop)
        total, calls = by_name.get(name, (0.0, 0))
        by_name[name] = (total + (stop - start) / 1e3, calls + 1)
    return busy_ns / 1e6, by_name


def trace_busy(path: str):
    """(busy ms, {name: (total us, calls)}) of the device activities
    (kernels, copies, memsets) in a torch.profiler chrome trace."""
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return busy_and_names(
        (e["name"], e["ts"] * 1e3, (e["ts"] + e["dur"]) * 1e3)
        for e in events if e.get("ph") == "X"
        and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))


if __name__ == "__main__":
    import sys

    print_top_ops(sys.argv[1], n=int(sys.argv[2]) if len(sys.argv) > 2
                  else 30)
