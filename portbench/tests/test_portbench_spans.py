"""portbench/spans.py on the CPU at a tiny size: the QA cell's program
spans group into one call a batch, tile it, and take the harness's step
span as parent; the training cell reports its two train spans a step;
--oncost alternates the recorder. (On the CPU the profiler's events are
the host's ops, so the device numbers here are only read, not judged.)"""

import json
import os

import torch

from portbench import spans
from portbench.tests import tiny

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CPU = torch.device("cpu")
SEED = 2 ** 31 + 123


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_qa_spans_read():
    out = spans.traced(bench(), "mistral-7b.shortqa_b8", tiny.cfg(),
                       tiny.mix(), SEED, 1.0, CPU)
    assert out["bad_batches"] == [] and out["batches"] > 0
    assert out["calls"] == out["batches"] == out["window_steps"]
    assert out["parents"] == [("generate.decode_step", "harness.step"),
                              ("generate.prefill", "harness.step")]
    assert out["max_gap_us"] < 100
    lo, hi = out["covered_share"]
    assert 0 < lo <= hi <= 1
    assert out["remainder_ms"][1] >= 0
    for k in ("prefill_ms", "decode_step_ms", "decode_idle_share",
              "decode_ops_per_step", "inside_share"):
        assert out[k] is not None, k
    assert out["steps"] and out["activities"] > 0
    names = [row[0] for row in out["idle_named"]]
    assert {"generate.prefill", "generate.decode_step"} & set(names)
    assert out["accepted"]["qa_per_min"] > 0
    json.dumps(out)


def test_train_spans_read():
    out = spans.traced(bench(), "mistral-7b.train_projector", tiny.cfg(),
                       tiny.train(), SEED, 0.5, CPU)
    assert set(out["span_ms"]) == {"train.loss_and_grad", "train.update"}
    for ms, n in out["span_ms"].values():
        assert ms > 0 and n == out["window_steps"]
    assert out["parents"] == [("train.loss_and_grad", "harness.step"),
                              ("train.update", "harness.step")]


def test_oncost_alternates():
    out = spans.oncost(tiny.cfg(), tiny.mix(), SEED, 0.3, 4, CPU)
    assert [r["recorder"] for r in out["rows"]] == [False, True, True,
                                                    False]
    assert all((r["spans"] > 0) == r["recorder"] for r in out["rows"])
    assert out["on_median"] > 0 and out["off_median"] > 0
