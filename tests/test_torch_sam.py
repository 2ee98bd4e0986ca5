"""models/tiny_vit.py and models/sam.py against the JAX package on the
tiny MobileSAM (the tiny TinyViT encoder, the tiny SAM prompt encoder and
mask decoder), parameters carried across by engine/convert: the encoder's
embeddings within 1e-4, box-prompted mask logits and IoU predictions
within 1e-3 (f32; logits of order 10), the Fourier positional
encoding within 1e-4 (sines of arguments of order 100), then SamSegmenter end to end from
uint8 frames: the batched device decode's binary masks and the per-frame
call's masks. Mask pixels whose logit lies within 1e-3 of 0 may flip; at
most 0.1% of them differ."""

import numpy as np
import jax.numpy as jnp
import torch

from video_llava_tpu.models import sam as jsam
from video_llava_tpu.models import tiny_vit as jtv
from video_llava_tpu_torch.models import sam as tsam
from video_llava_tpu_torch.models import tiny_vit as ttv
from torch_grounding_pair import (
    sam_pair,
    sam_segmenters,
    textured_frames,
)


def test_tiny_vit_and_sam_decoder_match_jax():
    jp, tp = sam_pair()
    jcfg, tcfg = jtv.TinyViTConfig.tiny_test(), ttv.TinyViTConfig.tiny_test()
    rng = np.random.default_rng(0)
    px = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    jemb = jtv.encoder(jp["vision"], jnp.asarray(px), jcfg)
    temb = ttv.encoder(tp["vision"], torch.from_numpy(px), tcfg)
    np.testing.assert_allclose(temb.numpy(), np.asarray(jemb), atol=1e-4)

    boxes = np.asarray([[[4, 6, 40, 30], [10, 12, 60, 44], [0, 0, 63, 63]],
                        [[20, 5, 30, 50], [1, 1, 8, 8], [30, 30, 62, 50]]],
                       np.float32)
    scfg, tscfg = jsam.SamConfig.tiny_test(), tsam.SamConfig.tiny_test()
    jm, ji = jsam.predict_from_embeddings(jp, jemb, jnp.asarray(boxes), scfg)
    tm, ti = tsam.predict_from_embeddings(tp, torch.from_numpy(
        np.array(jemb)), torch.from_numpy(boxes), tscfg)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-3)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=1e-3)
    np.testing.assert_allclose(
        tsam.image_positional_embedding(tp, 8).numpy(),
        np.asarray(jsam.image_positional_embedding(jp, 8)), atol=1e-4)

    jseg, tseg = sam_segmenters((jp, tp))
    frames = textured_frames(3, 48, 80, seed=5)
    fboxes = np.asarray([[[4, 4, 40, 30], [10, 12, 60, 44]],
                         [[0, 0, 30, 30], [20, 10, 70, 40]],
                         [[5, 5, 20, 20], [30, 20, 75, 45]]], np.float32)
    want = np.asarray(jseg.decode_masks_batch_device(frames, fboxes,
                                                     out_hw=(56, 80)))
    got = tseg.decode_masks_batch_device(frames, fboxes,
                                         out_hw=(56, 80)).numpy()
    assert got.shape == want.shape == (3, 2, 56, 80) and got.dtype == np.uint8
    assert np.mean(got != want) <= 1e-3 and want.any()
    for f in range(3):
        w = jseg(frames[f], fboxes[f])
        g = tseg(frames[f], fboxes[f])
        assert g.shape == w.shape and np.mean(g != w) <= 1e-3
    tseg.precompute_embeddings(frames, [0, 2])
    assert tseg.num_cached_embeddings() == 2
    np.testing.assert_array_equal(tseg(frames[2], fboxes[2], frame_index=2),
                                  tseg(frames[2], fboxes[2]))
