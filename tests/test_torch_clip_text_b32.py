"""The port's CLIP text tower and pooled vision embedding against the
JAX package's, f32, at tiny configs (2 layers, width 32) with the
parameters carried across (engine/convert.clip_text_from_jax,
clip_vision_from_jax): text_forward pooled at the argmax id and at the
first eot_token_id (a row whose EOT is followed by larger ids, one whose
EOT is not its last token, one padded with zeros), causal through
multi_head_attention's plain reference here; vision_pooled_embedding at
56 px (17 tokens padded to 32). Each within 1e-5 of its scale. The
ViT-B/32 configs match the JAX package's, and its vision tower pads 50
tokens to 64."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import torch

from torch_xmem_pair import META, TEXT_KW, VISION_KW, one_torch_thread
from video_llava_tpu.config import CLIPTextConfig as JTextCfg
from video_llava_tpu.config import CLIPVisionConfig as JVisionCfg
from video_llava_tpu.models import clip as jclip
from video_llava_tpu_torch.config import CLIPTextConfig, CLIPVisionConfig
from video_llava_tpu_torch.engine.convert import (
    clip_text_from_jax,
    clip_vision_from_jax,
)
from video_llava_tpu_torch.models import clip as tclip


def _close(got, want, tol=1e-5):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() / np.abs(want).max() < tol


@one_torch_thread()
def test_text_and_pooled_towers_match_jax():
    assert (dataclasses.asdict(CLIPTextConfig.b32())
            == dataclasses.asdict(JTextCfg.b32()))
    assert tclip.padded_length(CLIPVisionConfig.b32().num_positions) == 64

    jt, tt = JTextCfg(**TEXT_KW), CLIPTextConfig(**TEXT_KW)
    jparams = jclip.init_text_params(jax.random.PRNGKey(1), jt)
    tparams = clip_text_from_jax(jax.tree.map(np.asarray, jparams),
                                 tclip.init_text_params(META, tt))
    ids = np.zeros((3, 77), np.int32)
    ids[0, :12] = np.r_[1, np.arange(40, 49), 7, 250]  # EOT 7, then 250
    ids[1, :6] = [1, 299, 5, 9, 7, 3]  # argmax 299 mid-row; EOT 7 not last
    ids[2, :4] = [1, 17, 18, 299]  # EOT last, zero padding
    for eot in (None, 7):
        want = jclip.text_forward(jparams, jnp.asarray(ids), jt,
                                  eot_token_id=eot)
        got = tclip.text_forward(tparams, torch.from_numpy(ids), tt,
                                 eot_token_id=eot)
        _close(got, want)

    jv, tv = JVisionCfg(**VISION_KW), CLIPVisionConfig(**VISION_KW)
    vparams = jclip.init_vision_params(jax.random.PRNGKey(0), jv)
    tower = clip_vision_from_jax(jax.tree.map(np.asarray, vparams), tv)
    px = np.random.default_rng(0).normal(size=(3, 56, 56, 3)).astype(
        np.float32)
    want = jclip.vision_pooled_embedding(vparams, jnp.asarray(px), jv)
    got = tclip.vision_pooled_embedding(tower, torch.from_numpy(px))
    assert got.shape == (3, 32)
    _close(got, want)
