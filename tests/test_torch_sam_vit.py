"""SAM with its ViT image encoder (--sam_variant vit_b), port against the
JAX package: a seeded tiny HF SamModel's state dict (SamConfig.tiny_test:
2 layers of width 32, windows of 2 with the second layer global, as
tests/test_mobile_sam.py's _hf_sd builds it) goes through both packages'
convert_hf_sam (trees equal leaf for leaf; engine/convert.sam_from_jax
carries the JAX tree into the same tree), then vision_encoder on seeded
pixels (within 1e-5 of the embeddings' scale) and predict_boxes (mask
logits and IoU within 1e-4 of their scale). The port's build_sam reads
the state dict saved as an HF directory (variant 'vit_b', on the CPU)
and its SamSegmenter, with the ViT encoder as its default encode_fn,
gives the JAX segmenter's masks for three boxes. grounding/synthetic
.sam_hf_state writes the tree back into the layout convert_hf_sam
reads, leaf for leaf, and init_vision_params draws a tree of that
layout."""

import numpy as np
import torch
import jax
import jax.numpy as jnp

from test_mobile_sam import _hf_sd
from torch_grounding_ckpt_pair import (
    assert_trees_equal,
    one_torch_thread,
    rel_err,
)
from video_llava_tpu.grounding import builders as jbuild
from video_llava_tpu.models import sam as jsam
from video_llava_tpu_torch.engine.convert import sam_from_jax
from video_llava_tpu_torch.grounding import builders as tbuild
from video_llava_tpu_torch.grounding import synthetic
from video_llava_tpu_torch.models import sam as tsam
from video_llava_tpu_torch.models.layers import TreeInit


def test_sam_vit_checkpoint_matches_jax(tmp_path):
    jcfg, tcfg = jsam.SamConfig.tiny_test(), tsam.SamConfig.tiny_test()
    sd = _hf_sd(jcfg)
    jp = jsam.convert_hf_sam(sd, jcfg)
    tp = tsam.convert_hf_sam(sd, tcfg)
    assert_trees_equal(jp, tp)
    assert_trees_equal(tp, sam_from_jax(jax.tree.map(np.asarray, jp), tcfg))

    rng = np.random.default_rng(0)
    px = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    boxes = np.asarray([[[4, 6, 40, 50], [20, 10, 60, 30]],
                        [[0, 0, 63, 63], [30, 30, 50, 60]]], np.float32)
    j_emb = np.asarray(jsam.vision_encoder(jp["vision"], jnp.asarray(px),
                                           jcfg.vision))
    j_masks, j_iou = jsam.predict_boxes(jp, jnp.asarray(px),
                                        jnp.asarray(boxes), jcfg)
    with one_torch_thread(), torch.inference_mode():
        t_emb = tsam.vision_encoder(tp["vision"], torch.from_numpy(px),
                                    tcfg.vision)
        t_masks, t_iou = tsam.predict_boxes(
            tp, torch.from_numpy(px), torch.from_numpy(boxes), tcfg,
            lambda p, x: tsam.vision_encoder(p["vision"], x, tcfg.vision))
    assert t_emb.shape == (2, 8, 8, 16)
    assert rel_err(t_emb.numpy(), j_emb) < 1e-5
    assert rel_err(t_masks.numpy(), np.asarray(j_masks)) < 1e-4
    assert rel_err(t_iou.numpy(), np.asarray(j_iou)) < 1e-4

    # build_sam from an HF directory; the segmenter's default encoder
    d = tmp_path / "sam_vit"
    d.mkdir()
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
               d / "pytorch_model.bin")
    seg = tbuild.build_sam(str(d), tcfg, variant="vit_b", device="cpu")
    assert_trees_equal(tp, seg.params)
    jseg = jbuild.SamSegmenter(jp, jcfg)
    frame = rng.integers(0, 256, size=(48, 80, 3), dtype=np.uint8)
    frame_boxes = np.asarray([[4, 6, 40, 40], [30, 8, 78, 46],
                              [10, 20, 30, 44]], np.float32)
    with one_torch_thread():
        got = seg(frame, frame_boxes)
    want = jseg(frame, frame_boxes)
    assert got.shape == (3, 48, 80)
    assert np.mean(got != want) < 1e-3

    # the released-layout writer, and a random tree of that layout
    assert_trees_equal(tp, tsam.convert_hf_sam(synthetic.sam_hf_state(
        tp, tcfg), tcfg))
    drawn = {"vision": tsam.init_vision_params(TreeInit(0, "cpu"),
                                               tcfg.vision),
             **tsam.init_decoder_params(TreeInit(1, "cpu"), tcfg)}
    assert_trees_equal(drawn, tsam.convert_hf_sam(synthetic.sam_hf_state(
        drawn, tcfg), tcfg))
