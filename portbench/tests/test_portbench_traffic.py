"""The traffic drawn from a seed repeats exactly, and every seed draws
the same sizes in another order."""

import collections

import numpy as np

from portbench.tests import tiny
from portbench.traffic import batched_qa as qa

BIG = 2 ** 31 + 12345


def _batches(seed, n, mix=None):
    plan = qa.Plan(tiny.cfg(), mix or tiny.mix(), seed)
    return [plan.batch(k) for k in range(n)]


def test_same_seed_same_traffic():
    a, b = _batches(BIG, 12), _batches(BIG, 12)
    for x, y in zip(a, b):
        assert np.array_equal(x.clips, y.clips) and x.answer == y.answer
        assert all(np.array_equal(p, q) for p, q in zip(x.prompts, y.prompts))
    c = _batches(BIG + 1, 12)
    assert any(not np.array_equal(x.prompts[0], y.prompts[0])
               for x, y in zip(a, c))


def test_every_seed_same_sizes():
    mix = tiny.mix(transcript_tokens=[10, 40])
    lo, hi = mix["answer_tokens"]
    block = 2 * (hi - lo + 1)
    for seed in (0, 7, BIG):
        bs = _batches(seed, block, mix)
        answers = [b.answer for b in bs]
        assert collections.Counter(answers) == collections.Counter(
            list(range(lo, hi + 1)) * 2)
        assert all(answers[i] + answers[i + 1] == lo + hi
                   for i in range(0, block, 2))
        total = sum(len(p) for p in bs[0].prompts)
        for b in bs:  # the same question and transcript lengths, reordered
            assert sum(len(p) for p in b.prompts) == total
        clips = np.concatenate([b.clips for b in bs[:2]])
        assert collections.Counter(clips.tolist()) == collections.Counter(
            list(range(mix["clips"])) * (2 * mix["batch"] // mix["clips"]))


def test_prompt_layout():
    cfg, mix = tiny.cfg(), tiny.mix()
    plan = qa.Plan(cfg, mix, BIG)
    v = cfg["vision_config"]
    video = (v["image_size"] // v["patch_size"]) ** 2 \
        + cfg["max_temporal_tokens"]
    for p in plan.batch(3).prompts:
        assert p[0] == cfg["bos_token_id"]
        assert (p == cfg["vid_patch_token_id"]).sum() == video
        assert (p == cfg["vid_start_token_id"]).sum() == 1
        assert not np.isin(p[1:], [cfg["bos_token_id"], cfg["eos_token_id"],
                                   cfg["pad_token_id"]]).any()
        lo, hi = mix["question_tokens"]
        fixed = 1 + sum(mix["template_tokens"]) + video + 2
        assert lo <= len(p) - fixed <= hi
