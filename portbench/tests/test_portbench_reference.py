"""The plain reference agrees with the port's CPU path at a tiny size:
the projected video tokens (CLIP, pooling, projector), the prefill's
logits at each prompt's last position, and the greedy tokens of a
generation, with the program built in float32 from the same seed."""

import numpy as np
import torch

from portbench.reference import model as ref
from portbench.tests import tiny
from portbench.traffic import batched_qa as qa


def test_reference_matches_port_cpu():
    from video_llava_tpu_torch.config import GenerationConfig

    cfg, mix = tiny.cfg(), tiny.mix()
    seed, dev = 2 ** 31 + 3, torch.device("cpu")
    eng = qa.build_engine(cfg, mix, seed, dev, dtype=torch.float32)
    pool = qa.clip_pool(seed, mix, dev)
    b = qa.Plan(cfg, mix, seed).batch(0)
    with torch.no_grad():
        feats = eng.batched_encode(pool[b.clips], [mix["frames"]] * len(
            b.clips))
        got = eng.model.projector(feats.float())
        want = torch.stack([ref.video_tokens(
            seed, cfg, torch.from_numpy(pool[c])) for c in b.clips])
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()
        lens = [len(p) for p in b.prompts]
        bucket = -(-max(lens) // 16) * 16
        ids = np.zeros((len(lens), bucket), np.int64)
        for r, p in enumerate(b.prompts):
            ids[r, :len(p)] = p
        ids_t, lens_t = torch.from_numpy(ids), torch.tensor(
            lens, dtype=torch.int32)
        pre = eng.model.prefill(ids_t, lens_t, feats, bucket, torch.float32)
        gen = GenerationConfig(max_new_tokens=4, temperature=0.0,
                               do_sample=False, eos_token_id=-1,
                               pad_token_id=0)
        toks = eng.generate_tokens(ids_t, lens_t, feats, gen, seed=0).tokens
    rows = [{"ids": torch.from_numpy(np.concatenate([p, t[:-1].numpy()])),
             "prompt_len": len(p), "video": want[i],
             "at": torch.arange(len(p) - 1, len(p) + 3)}
            for i, (p, t) in enumerate(zip(b.prompts, toks))]
    logits = ref.decoder_logits(seed, cfg, rows)
    for i, lg in enumerate(logits):
        # int8 activations: a rounding that flips between the two sums
        # moves a row by a step, so a few percent of the largest logit
        err = (pre.logits_last[i] - lg[0]).abs().max() / lg[0].abs().max()
        assert err < 0.05
        assert ref.served_gaps(lg, toks[i]).max() < 0.3


def test_formats_follow_the_program():
    from video_llava_tpu_torch.ops.quant import leaf_format

    for shape in ((32, 4096, 4096), (32, 4096, 1024), (32, 14336, 4096),
                  (1, 4096, 32006), (1, 256, 128), (2, 256, 128),
                  (30, 4096, 11008)):
        want = leaf_format(("layers", "wq", "kernel"), shape, "int4")
        assert ref.quant.weight_format(shape) == want
