"""torch.profiler trace parsing: aggregate device op times.

Counterpart of video_llava_tpu/utils/trace_tools.py. The port's traces
are torch.profiler chrome traces: `prof.export_chrome_trace(path)`, or
the `*.pt.trace.json[.gz]` files that
`torch.profiler.tensorboard_trace_handler(dir)` writes. This module reads
one back and sums the complete ('X') events of the device's activity
(kernels, copies, memsets) by name, so a profile decomposes without
TensorBoard. A trace without device activity (a CPU run) falls back to
every complete event, as the JAX reader falls back to every track.

It also holds the program's span recorder: named host intervals on
``time.perf_counter_ns`` (the clock a benchmark harness reads its own
spans on), kept in memory while the recorder is on (:func:`enable`) and
handed out by :func:`drain`. Off, which is the default, a span costs one
flag test and records nothing. The engine's decode loop
(engine/generate.py) records ``generate.prefill`` and one
``generate.decode_step`` a forward, each ended right after a host read
that already waits for the device, so a step's span holds its kernels;
the train step (train/train_step.py) records ``train.loss_and_grad`` and
``train.update``, which mark the host's place only. A span's parent is
the span open on the same thread when it began. Read against a
profiler's device activities on the same clock, :func:`decode_report`
gives the prefill's and a decode step's time, a step's idle share and
its device operations, and :func:`idle_by_span` names the device's idle
gaps by the span the host was in (portbench/spans.py drives both on the
benchmark's cells).

Run: python -m video_llava_tpu_torch.utils.trace_tools TRACE_DIR [N]
"""

from __future__ import annotations

import bisect
import collections
import functools
import glob
import gzip
import heapq
import itertools
import json
import os
import statistics
import threading
import time
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

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


class Span(NamedTuple):
    """A recorded span: ns on time.perf_counter_ns; `parent` is the id
    of the span open on the same thread when it began (None if none)."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]


class _Open:
    __slots__ = ("name", "start_ns", "id", "parent", "level")

    def __init__(self, name: str, start_ns: int, id: int,
                 parent: Optional[int], level: int):
        self.name, self.start_ns, self.id = name, start_ns, id
        self.parent, self.level = parent, level


class _Stack(threading.local):
    def __init__(self):
        self.open: List[_Open] = []


_ON = False
_DONE: List[Span] = []
_LOCK = threading.Lock()
_STACK = _Stack()
_IDS = itertools.count()


def enable(on: bool = True) -> None:
    """Turn the span recorder on (or off). Spans begun while it is off
    are not recorded."""
    global _ON
    _ON = on


def _push(name: str, t: int) -> _Open:
    stack = _STACK.open
    sp = _Open(name, t, next(_IDS), stack[-1].id if stack else None,
               len(stack))
    stack.append(sp)
    return sp


def begin(name: str) -> Optional[_Open]:
    """Open a span named `name` now on this thread; None, and nothing
    recorded, while the recorder is off."""
    return _push(name, time.perf_counter_ns()) if _ON else None


def _close(sp: _Open, t: int) -> None:
    stack = _STACK.open
    if len(stack) <= sp.level or stack[sp.level] is not sp:
        return  # ended already, or dropped as left open
    # spans left open inside it (by an exception) end unrecorded
    del stack[sp.level:]
    with _LOCK:
        _DONE.append(Span(sp.name, sp.start_ns, t, sp.id, sp.parent))


def end(sp: Optional[_Open]) -> None:
    """Close and record a span that :func:`begin` opened on this thread
    (None, or a span ended already: no-op)."""
    if sp is not None:
        _close(sp, time.perf_counter_ns())


def switch(sp: Optional[_Open], name: str) -> Optional[_Open]:
    """End `sp` (if any) and begin `name` at the same instant, so that
    the two tile; the new span's parent is `sp`'s."""
    if sp is None:
        return begin(name)
    t = time.perf_counter_ns()
    _close(sp, t)
    return _push(name, t) if _ON else None


def unwinding(fn):
    """Decorator: spans that a call of `fn` leaves open on this thread
    when it raises are dropped, unrecorded, so that later spans take the
    right parent. Off, a call costs one flag test more."""

    @functools.wraps(fn)
    def call(*args, **kwargs):
        if not _ON:
            return fn(*args, **kwargs)
        depth = len(_STACK.open)
        try:
            return fn(*args, **kwargs)
        except BaseException:
            del _STACK.open[depth:]
            raise

    return call


def drain() -> List[Span]:
    """The spans recorded since the last drain, by start; clears them."""
    global _DONE
    with _LOCK:
        done, _DONE = _DONE, []
    return sorted(done, key=lambda s: (s.start_ns, s.id))


def _union(intervals: Iterable[Tuple[int, int]]) -> List[List[int]]:
    """[start, end) intervals, sorted and merged."""
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        elif e > s:
            out.append([s, e])
    return out


def idle_by_span(events: Iterable[Tuple[str, int, int]],
                 spans: Iterable[Span], t0: int,
                 t1: int) -> Dict[str, List[float]]:
    """The device's idle gaps in [t0, t1] (between the union of the
    (name, start ns, end ns) device `events`), each named by the
    innermost recorded span open at its midpoint (of those open then,
    the latest begun), or "none" -> {name: [idle s, gaps, longest s]}.
    Events and spans on one clock."""
    busy = _union((max(s, t0), min(e, t1)) for _, s, e in events)
    order = sorted(spans, key=lambda x: x.start_ns)
    live: list = []  # heap of (-start, end, name), the latest begun on top
    out: Dict[str, List[float]] = {}
    edge, i = t0, 0
    for s, e in busy + [[t1, t1]]:
        if s > edge:
            mid = (edge + s) // 2
            while i < len(order) and order[i].start_ns <= mid:
                heapq.heappush(live, (-order[i].start_ns, order[i].end_ns,
                                      order[i].name))
                i += 1
            while live and live[0][1] <= mid:
                heapq.heappop(live)  # ended: the midpoints only move on
            row = out.setdefault(live[0][2] if live else "none",
                                 [0.0, 0, 0.0])
            row[0] += (s - edge) / 1e9
            row[1] += 1
            row[2] = max(row[2], (s - edge) / 1e9)
        edge = max(edge, e)
    return out


def generate_calls(spans: Iterable[Span]) -> List[List[Span]]:
    """The engine's generate calls in recorded spans: each a
    ``generate.prefill`` and the ``generate.decode_step`` spans that
    follow it under the same parent, in order."""
    calls: List[List[Span]] = []
    current: Dict[Optional[int], List[Span]] = {}
    for sp in sorted(spans, key=lambda x: (x.start_ns, x.id)):
        if sp.name == "generate.prefill":
            current[sp.parent] = [sp]
            calls.append(current[sp.parent])
        elif sp.name == "generate.decode_step" and sp.parent in current:
            current[sp.parent].append(sp)
    return calls


def decode_report(calls: List[List[Span]],
                  events: Iterable[Tuple[str, int, int]],
                  windows: Optional[List[Tuple[int, int]]] = None) -> dict:
    """What :func:`generate_calls`' calls and the device's (name, start
    ns, end ns) `events`, on one clock, say of the decode loop:

    - ``prefill_ms``: the mean prefill span;
    - ``decode_step_ms``: the mean decode-step span, each call's last
      step left out (it ends at the loop's return, its kernels still
      running; every other step ends at a read that waits for them);
    - ``decode_idle_share``: 100 (1 - the union of device activity
      inside those steps / their summed length);
    - ``decode_ops_per_step``: device activities that start inside those
      steps, a step; ``steps``: how many steps were read;
    - ``max_gap_us``: the widest gap between a call's consecutive spans;
    - ``inside_share``: of the activities that start inside a call's
      window (``windows[k]`` for call k, else the call's own extent),
      the share that lies wholly inside the span it starts in (in the
      call's last span, or after it: starting there is enough);
      ``activities``: how many were read.

    Values are None where there is nothing to read."""
    evs = sorted((s, e) for _, s, e in events)
    starts = [s for s, _ in evs]
    prefill, steps, max_gap = [], [], 0
    inside = total = 0
    for k, call in enumerate(calls):
        prefill.append(call[0].end_ns - call[0].start_ns)
        steps += call[1:-1]
        for a, c in zip(call, call[1:]):
            max_gap = max(max_gap, c.start_ns - a.end_ns)
        w0, w1 = (windows[k] if windows is not None
                  else (call[0].start_ns, call[-1].end_ns))
        span_starts = [sp.start_ns for sp in call]
        for s, e in evs[bisect.bisect_left(starts, w0):
                        bisect.bisect_right(starts, w1)]:
            total += 1
            j = bisect.bisect_right(span_starts, s) - 1
            inside += j >= 0 and (j == len(call) - 1 or e <= call[j].end_ns)
    merged = _union(evs)
    merged_starts = [s for s, _ in merged]
    busy = ops = length = 0
    for sp in steps:
        ops += (bisect.bisect_left(starts, sp.end_ns)
                - bisect.bisect_left(starts, sp.start_ns))
        length += sp.end_ns - sp.start_ns
        j = max(bisect.bisect_right(merged_starts, sp.start_ns) - 1, 0)
        while j < len(merged) and merged[j][0] < sp.end_ns:
            busy += max(0, min(merged[j][1], sp.end_ns)
                        - max(merged[j][0], sp.start_ns))
            j += 1
    return {
        "prefill_ms": statistics.fmean(prefill) / 1e6 if prefill else None,
        "decode_step_ms": length / len(steps) / 1e6 if steps else None,
        "decode_idle_share": (100.0 * (1 - busy / length) if length
                              else None),
        "decode_ops_per_step": ops / len(steps) if steps else None,
        "steps": len(steps),
        "max_gap_us": max_gap / 1e3 if calls else None,
        "inside_share": inside / total if total else None,
        "activities": total,
    }


if __name__ == "__main__":
    import sys

    print_top_ops(sys.argv[1], n=int(sys.argv[2]) if len(sys.argv) > 2
                  else 30)
