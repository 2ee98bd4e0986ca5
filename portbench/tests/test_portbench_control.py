"""The control, judged in the program's place by the same limits, comes
out not correct where the program comes out correct: the reference one
precision step lower (reference/model.CONTROL), or the program's own
path of lower precision where the mix names one (its ``control``).

On the CPU at a tiny size; and, marked ``gpu``, on the card at each
cell's own size and load, on three seeds (the readings PERF.md gives
for the limits):

    python3 -m pytest -m gpu portbench/tests/test_portbench_control.py
"""

import json
import os
import time

import pytest
import torch

from portbench import run
from portbench.tests import tiny

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def test_control_fails_tiny():
    for seed in (11, 2 ** 31 + 11):
        out = run.run_cell(tiny.cfg(), tiny.mix(), [], seed, 1.0,
                           False, torch.device("cpu"), time.monotonic(),
                           control=True)
        assert out["program"]["correct"], out["program"]["checks"]
        assert not out["correct"], out["checks"]
        limit = tiny.MIX["check"]["widest_gap_limit"]
        assert out["checks"]["widest_gap"]["value"] > limit


@pytest.mark.gpu
def test_control_fails_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells' own sizes")
    run.cache_dirs()
    bench = os.path.join(ROOT, "BENCHMARK.json")
    with open(bench) as f:
        cells = [w["name"] for w in json.load(f)["workloads"]]
    dev = torch.device("cuda", 0)
    for cell in cells:
        _, _, cfg, mix = run.resolve(cell, bench)
        for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
            low = run.run_cell(cfg, mix, [], seed, 8.0, False, dev,
                               time.monotonic(), control=True)
            torch.cuda.empty_cache()
            assert not low["correct"], (cell, seed, low["checks"])
            prog = low.get("program") or run.run_cell(
                cfg, mix, [], seed, 8.0, False, dev, time.monotonic())
            assert prog["correct"], (cell, seed, prog["checks"])
            print(json.dumps({"cell": cell, "seed": seed,
                              "program": prog["checks"],
                              "control": low["checks"]}), flush=True)
            torch.cuda.empty_cache()
