"""The device trace of a run's window, summarized in memory.

The traced run records the device's activity (kernels, copies, memsets)
with torch.profiler and reads kineto's events as recorded, without a
chrome trace. From them: the busy time (the union of the activities'
intervals, as utils/trace_tools.busy_and_names in the program sums
it), each name's device seconds and calls, the device operations that
took most time, and the idle gaps, each named by the harness span that
the host was in during it.
"""

from __future__ import annotations

import re
import time
from typing import Dict, List, Sequence, Tuple

Span = Tuple[str, int, int]  # (label, start ns, end ns) on perf_counter_ns


class Window:
    """Start the profiler and mark the window's ends on two clocks."""

    def __init__(self, enabled: bool, cuda: bool = True):
        self.enabled, self.cuda = enabled, cuda
        self.prof = None

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[
                ProfilerActivity.CUDA if self.cuda else ProfilerActivity.CPU])
            self.prof.__enter__()
        self.wall0, self.perf0 = time.time_ns(), time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.perf1 = time.perf_counter_ns()
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False

    @property
    def seconds(self) -> float:
        return (self.perf1 - self.perf0) / 1e9

    def device_events(self) -> List[Tuple[str, int, int]]:
        """(name, start ns, end ns) of every device activity (of every
        host op, in a run on the CPU), moved onto
        perf_counter_ns: kineto stamps them on the wall clock or on the
        monotonic one, whichever is nearer the window's start."""
        from torch.autograd import DeviceType

        kind = DeviceType.CUDA if self.cuda else DeviceType.CPU
        events = [(e.name(), e.start_ns(), e.end_ns())
                  for e in self.prof.profiler.kineto_results.events()
                  if e.device_type() == kind]
        if not events:
            return []
        first = min(s for _, s, _ in events)
        shift = (self.wall0 - self.perf0
                 if abs(first - self.wall0) < abs(first - self.perf0) else 0)
        return [(n, s - shift, e - shift) for n, s, e in events]


def union(intervals: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The union of [start, end) intervals, sorted and merged."""
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def summarize(events, spans: Sequence[Span], t0: int, t1: int,
              top: int = 10) -> dict:
    """Busy seconds inside [t0, t1], {name: [device seconds, calls]},
    the `top` device operations by time and the idle time by the host
    span it fell in (its gaps' count and longest)."""
    by_name: Dict[str, List[float]] = {}
    clipped = []
    for name, s, e in events:
        row = by_name.setdefault(name, [0.0, 0])
        row[0] += (e - s) / 1e9
        row[1] += 1
        s, e = max(s, t0), min(e, t1)
        if e > s:
            clipped.append((s, e))
    busy = union(clipped)
    busy_s = sum(e - s for s, e in busy) / 1e9
    gaps = []
    edge = t0
    for s, e in busy + [(t1, t1)]:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, e)
    spans = sorted(spans, key=lambda x: x[1])
    idle: Dict[str, List[float]] = {}
    j = 0
    for s, e in gaps:
        mid = (s + e) // 2
        while j + 1 < len(spans) and spans[j + 1][1] <= mid:
            j += 1
        label = (spans[j][0] if spans and spans[j][1] <= mid <= spans[j][2]
                 else "harness")
        row = idle.setdefault(label, [0.0, 0, 0.0])
        row[0] += (e - s) / 1e9
        row[1] += 1
        row[2] = max(row[2], (e - s) / 1e9)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    gaps_named = sorted(idle.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "busy_s": busy_s,
        "by_name": by_name,
        "device_ops": [[n, v[0]] for n, v in ops],
        "idle_gaps": [[f"{n} ({int(v[1])} gaps, longest {v[2]:.6f} s)",
                       v[0]] for n, v in gaps_named],
    }


def device_seconds(by_name: Dict[str, List[float]],
                   patterns: Sequence[str]) -> float:
    """Device seconds of the activities whose name matches a pattern."""
    res = [re.compile(p) for p in patterns]
    return sum(v[0] for n, v in by_name.items()
               if any(r.search(n) for r in res))
