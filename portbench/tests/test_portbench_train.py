"""The training cell on the CPU at a tiny size: the check passes a sound
run, and fails each fault a training step can have here: a step that
leaves its state unchanged, and a loss over half of the batch."""

import time

import torch

from portbench import run
from portbench.calibrate import half_batch
from portbench.tests import tiny

LIMITS = {"loss_rel": 0.01, "grad_norm_gap": 0.02, "grad_rel_err": 0.1,
          "change_norm_gap": 0.05}


def checks(seed=2 ** 31 + 9):
    out = run.run_cell(tiny.cfg(), tiny.train(check=LIMITS), [],
                       seed, 0.5, False, torch.device("cpu"),
                       time.monotonic())
    return out["correct"], {k: v["value"] for k, v in out["checks"].items()}


def test_sound_training_is_correct():
    ok, got = checks()
    assert ok, got


def test_state_left_unchanged(monkeypatch):
    from video_llava_tpu_torch.train import train_step

    def unchanged(self, grads, state, params):
        return {**state, "count": state["count"] + 1,
                "mu": {n: (1 - self.b1) * g for n, g in grads.items()}}

    monkeypatch.setattr(train_step.AdamW, "update", unchanged)
    ok, got = checks()
    assert not ok and got["change_norm_gap"] > 0.99


def test_half_the_batch():
    with half_batch():
        ok, got = checks()
    assert not ok, got
