"""models/grounding_dino.py against the JAX package's GroundingDINO on
the tiny config (random HF weights through the JAX converter, carried
across by engine/convert.tree_from_jax): the full two-stage forward's
logits (finite entries within 1e-4, -inf where JAX has -inf) and boxes
(1e-5), then GroundingDinoDetector.detect_batch end to end from uint8
frames (bicubic preprocessing, class spans, thresholding): the same
detections and classes, scores within 1e-4 and boxes within 1e-2 px
(the preprocessing rounds resized pixels to grey levels, and a pixel
the two resizes put on either side of .5 moves by one). The tiny
detector's 20 queries come from more valid proposals than queries, so
the two-stage top-k picks one set; its order follows jax.lax.top_k."""

import numpy as np
import jax.numpy as jnp
import torch

from video_llava_tpu.models import grounding_dino as jgd
from video_llava_tpu_torch.models import grounding_dino as tgd
from torch_grounding_pair import dino_pair, textured_frames


def test_grounding_dino_forward_and_detect_batch_match_jax():
    jp, tp = dino_pair()
    cfg, tcfg = jgd.GroundingDinoConfig.tiny_test(), \
        tgd.GroundingDinoConfig.tiny_test()
    rng = np.random.default_rng(0)
    px = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    ids = np.asarray([[101, 5, 6, 1012, 7, 8, 9, 1012, 102]] * 2)
    jl, jb = (np.asarray(a) for a in jgd.forward(jp, cfg, jnp.asarray(px),
                                                  ids))
    tl, tb = (a.numpy() for a in tgd.forward(tp, tcfg, torch.from_numpy(px),
                                             ids))
    fin = np.isfinite(jl)
    np.testing.assert_array_equal(np.isfinite(tl), fin)
    np.testing.assert_allclose(tl[fin], jl[fin], atol=1e-4)
    np.testing.assert_allclose(tb, jb, atol=1e-5)

    tok = tgd.char_tokenize
    jdet = jgd.GroundingDinoDetector(jp, cfg, tok, image_size=64,
                                     box_threshold=0.3)
    tdet = tgd.GroundingDinoDetector(tp, tcfg, tok, image_size=64,
                                     box_threshold=0.3)
    frames = textured_frames(3, 48, 80)
    prompts = ["cat", "red dog"]
    want = jdet.detect_batch(frames, prompts)
    got = tdet.detect_batch(frames, prompts)
    assert sum(len(w[0]) for w in want) > 0
    for (gb, gs, gc), (wb, ws, wc) in zip(got, want):
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_allclose(gs, ws, atol=1e-4)
        np.testing.assert_allclose(gb, wb, atol=1e-2)
    one = tdet(frames[1], prompts)
    np.testing.assert_array_equal(one[2], got[1][2])
