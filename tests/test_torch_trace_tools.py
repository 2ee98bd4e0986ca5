"""utils/trace_tools.py: (1) a real torch.profiler trace of a CPU run
(export_chrome_trace, gzipped, under a nested directory as
tensorboard_trace_handler writes it) holds no device activity, so
device_op_totals falls back to every complete event (source 'all'),
rows sorted by total time, the matmul among them; the JAX package's
reader takes the same fallback on that file (no device track) and
agrees on the op's total; (2) a synthetic chrome trace with kernel,
gpu_memcpy, gpu_memset and cpu_op events: only the device events are
counted (source 'device'), summed by name, include_substr filtering,
and trace_busy's busy time is the union of their intervals; (3)
busy_and_names on overlapping and disjoint spans equals the length of
the union computed on a grid, with per-name totals and calls."""

import gzip
import json
import os

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from video_llava_tpu.utils import trace_tools as jtrace
from video_llava_tpu_torch.utils import trace_tools


def test_trace_tools_device_events_and_fallback(tmp_path, capsys):
    run = tmp_path / "run" / "plugins"
    run.mkdir(parents=True)
    a = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            a = torch.mm(a, a) / 64
    raw = tmp_path / "raw.json"
    prof.export_chrome_trace(str(raw))
    path = run / "host.pt.trace.json.gz"
    with open(raw, "rb") as f, gzip.open(path, "wb") as g:
        g.write(f.read())
    os.remove(raw)
    assert trace_tools.find_trace_file(str(tmp_path)) == str(path)
    rows = trace_tools.device_op_totals(str(tmp_path))
    assert rows.source == "all" and rows
    assert [r[1] for r in rows] == sorted((r[1] for r in rows), reverse=True)
    mm = dict((n, (ms, c)) for n, ms, c in rows)["aten::mm"]
    assert mm[1] == 3 and mm[0] > 0
    jrows = dict((n, (ms, c)) for n, ms, c in jtrace.device_op_totals(
        str(tmp_path), include_substr="aten::mm"))
    assert jrows["aten::mm"] == mm
    trace_tools.print_top_ops(str(tmp_path), n=3)
    out = capsys.readouterr().out
    assert "event time" in out and len(out.splitlines()) == 4

    events = [
        {"ph": "M", "name": "process_name", "pid": 1,
         "args": {"name": "python"}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 50},
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 10, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 25, "dur": 10},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 40,
         "dur": 4},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 60,
         "dur": 2},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 9, "dur": 3},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 70},
    ]
    synth = tmp_path / "synth"
    synth.mkdir()
    with open(synth / "x.pt.trace.json", "w") as f:
        json.dump({"traceEvents": events}, f)
    rows = trace_tools.device_op_totals(str(synth))
    assert rows.source == "device"
    assert list(rows) == [("gemm", 0.03, 2), ("Memcpy HtoD", 0.004, 1),
                          ("Memset", 0.002, 1)]
    assert list(trace_tools.device_op_totals(
        str(synth), include_substr="Mem")) == [("Memcpy HtoD", 0.004, 1),
                                               ("Memset", 0.002, 1)]
    busy_ms, by_name = trace_tools.trace_busy(str(synth / "x.pt.trace.json"))
    assert abs(busy_ms - (25 + 4 + 2) / 1e3) < 1e-12
    assert by_name["gemm"] == (30.0, 2)

    rng = np.random.default_rng(0)
    spans = []
    for i in range(40):
        start = int(rng.integers(0, 1000))
        spans.append((f"k{i % 3}", start * 1e3,
                      (start + int(rng.integers(1, 60))) * 1e3))
    grid = np.zeros(1100, bool)
    for _, s, e in spans:
        grid[int(s / 1e3):int(e / 1e3)] = True
    busy_ms, by_name = trace_tools.busy_and_names(spans)
    assert abs(busy_ms - grid.sum() / 1e3) < 1e-9
    for k in ("k0", "k1", "k2"):
        mine = [(e - s) / 1e3 for n, s, e in spans if n == k]
        assert by_name[k] == (sum(mine), len(mine))
