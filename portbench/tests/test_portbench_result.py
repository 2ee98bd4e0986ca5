"""A tiny run through the harness's pieces on the CPU: the result line's
keys, the metrics each cell reports, the refusal without a card, and no
module of JAX or of the JAX package loaded."""

import json
import os
import subprocess
import sys
import textwrap
import time

import torch

from portbench import run
from portbench.tests import tiny

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELL = "mistral-7b.shortqa_b8"


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def tiny_run(trace: bool, seconds: float = 1.0, **mix):
    metrics = run.cell_metrics(bench(), CELL, trace)
    out = run.run_cell(tiny.cfg(), tiny.mix(**mix), metrics,
                       2 ** 31 + 77, seconds, trace, torch.device("cpu"),
                       time.monotonic())
    return out, metrics


def test_result_line_keys():
    for trace in (False, True):
        out, metrics = tiny_run(trace)
        need = {"correct", "attempted", "failed", "metrics", "device",
                "checks", "check_s"} | ({"breakdown"} if trace else set())
        assert set(out) == need
        assert list(out)[-1] == "checks"
        assert out["correct"] is True and out["failed"] == 0
        assert out["attempted"] > 0
        names = {m["name"] for m in metrics}
        assert set(out["metrics"]) <= names
        for m in metrics:
            if not m["name"].endswith("_roofline"):  # no kernels on a CPU
                assert m["name"] in out["metrics"]
                assert out["metrics"][m["name"]]["unit"] == m["unit"]
        if trace:
            assert out["device"]["busy_s"] > 0
            assert out["device"]["window_s"] > 0
            assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
            assert all(len(out["breakdown"][k]) <= 10
                       for k in out["breakdown"])
        for c in out["checks"].values():
            assert set(c) == {"value", "limit"}
        json.dumps(out)


def test_cell_metrics_follow_workloads():
    b = bench()
    for w in b["workloads"]:
        e2e = {m["name"] for m in run.cell_metrics(b, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert ("answer_p95_s" in e2e) == (w["name"] == CELL)
        layer = run.cell_metrics(b, w["name"], True)
        assert layer and all(m["moves"] in e2e for m in layer)


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        return  # the refusal is for a machine without a card
    rc = run.main(["--workload", CELL, "--seed", "1", "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_no_jax_loaded():
    code = textwrap.dedent(f"""
        import sys, time, torch
        sys.path.insert(0, {ROOT!r})
        from portbench import run
        from portbench.tests import tiny
        run.run_cell(tiny.cfg(), tiny.mix(), [], 5, 0.5, True,
                     torch.device("cpu"), time.monotonic())
        assert "video_llava_tpu_torch" in sys.modules
        print(run.forbidden_modules())
    """)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"
