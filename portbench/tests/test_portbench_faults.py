"""The check fails a run whose timed path is broken underneath: the
harness's run on the CPU at a tiny size (its look for a card skipped),
with a fault planted in the program, must come out not correct."""

import time

import torch

from portbench import run
from portbench.tests import tiny


def tiny_correct(seed=2 ** 31 + 5) -> bool:
    out = run.run_cell(tiny.cfg(), tiny.mix(), [], seed, 1.0,
                       False, torch.device("cpu"), time.monotonic())
    return out["correct"]


def test_sound_run_is_correct():
    assert tiny_correct()


def test_token_altered_where_produced(monkeypatch):
    from video_llava_tpu_torch.engine import generate

    calls = {"n": 0}
    sample = generate.sample_token

    def altered(logits, *a, **k):  # every decode step's token, shifted
        tok = sample(logits, *a, **k)
        calls["n"] += 1
        return tok if calls["n"] % 2 else (tok + 1) % logits.shape[-1]

    monkeypatch.setattr(generate, "sample_token", altered)
    assert not tiny_correct()


def test_half_the_batch_left_out(monkeypatch):
    from video_llava_tpu_torch.runtime.inference import InferenceEngine

    real = InferenceEngine.generate_tokens

    def half(self, input_ids, seq_lens, feats, gen, seed, speculative=None):
        h = input_ids.shape[0] // 2  # the first half, its answers copied
        res = real(self, input_ids[:h], seq_lens[:h], feats[:h], gen, seed,
                   speculative)
        return res._replace(tokens=torch.cat([res.tokens] * 2),
                            lengths=torch.cat([res.lengths] * 2))

    monkeypatch.setattr(InferenceEngine, "generate_tokens", half)
    assert not tiny_correct()


def test_video_features_swapped(monkeypatch):
    from video_llava_tpu_torch.runtime.inference import InferenceEngine

    real = InferenceEngine.batched_encode

    def swapped(self, frames, counts):  # each row encodes the next video
        return real(self, frames, counts).roll(1, 0)

    monkeypatch.setattr(InferenceEngine, "batched_encode", swapped)
    assert not tiny_correct()
