"""Swin from checkpoints, port against the JAX package, in both layouts
the grounding stack reads: a seeded tiny HF SwinModel state dict
(tests/test_swin.py's config) through both packages' convert_hf_swin,
and the same weights written in timm's names (GroundingDINO's backbone.0,
RAM's visual_encoder: fused qkv) by grounding/synthetic.swin_timm_state
through both packages' convert_timm_swin. The trees are equal leaf for
leaf, to each other and across the layouts; forward_pooled of each
package agrees on seeded pixels within 1e-5 of the features' scale; the
port's build_tagger reads the HF directory (swin_checkpoint, on the CPU)
into the same backbone; swin.timm_window_size reads the window back from
the relative-position tables."""

import numpy as np
import torch
import jax.numpy as jnp

from torch_grounding_ckpt_pair import (
    assert_trees_equal,
    hf_swin_sd,
    one_torch_thread,
    rel_err,
)
from video_llava_tpu.models import swin as jswin
from video_llava_tpu_torch.grounding import builders as tbuild
from video_llava_tpu_torch.grounding import synthetic
from video_llava_tpu_torch.models import swin as tswin


def test_swin_checkpoints_match_jax(tmp_path):
    jcfg, sd = hf_swin_sd()
    tcfg = tswin.SwinConfig.tiny_test()
    j_hf = jswin.convert_hf_swin(sd, jcfg)
    t_hf = tswin.convert_hf_swin(sd, tcfg)
    assert_trees_equal(j_hf, t_hf)

    timm = synthetic.swin_timm_state(t_hf, tcfg, "visual_encoder.")
    assert "visual_encoder.layers.0.blocks.1.attn.qkv.weight" in timm
    timm_np = {k: v.numpy() for k, v in timm.items()}
    t_timm = tswin.convert_timm_swin(timm, tcfg, prefix="visual_encoder.")
    assert_trees_equal(jswin.convert_timm_swin(timm_np, jcfg,
                                               prefix="visual_encoder."),
                       t_timm)
    assert_trees_equal(t_hf, t_timm)
    assert tswin.timm_window_size(timm, "visual_encoder.") == 4

    px = np.random.default_rng(0).normal(size=(2, 64, 64, 3)).astype(
        np.float32)
    want = np.asarray(jswin.forward_pooled(j_hf, jnp.asarray(px), jcfg))
    with one_torch_thread(), torch.inference_mode():
        got = tswin.forward_pooled(t_hf, torch.from_numpy(px), tcfg).numpy()
    assert got.shape == (2, tcfg.num_features)
    assert rel_err(got, want) < 1e-5

    d = tmp_path / "swin"
    d.mkdir()
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
               d / "pytorch_model.bin")
    tagger = tbuild.build_tagger(swin_checkpoint=str(d), cfg=tcfg,
                                 tag_list=["dog", "cat", "car"],
                                 device="cpu")
    assert_trees_equal(t_hf, tagger.backbone_params)
    assert tagger.head_params["head"]["kernel"].shape == (
        tcfg.num_features, 3)
