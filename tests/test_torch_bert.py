"""models/bert.py against the JAX package's BERT on the tiny config's
parameters (random HF weights through the JAX converter, as
GroundingDINO's text tower holds them), with GroundingDINO's inputs: a
block-diagonal additive bias between special tokens and restarted
position ids from generate_text_masks, plus a padding mask. Last hidden
states within 1e-4 absolute (f32, LayerNorm'd)."""

import numpy as np
import jax.numpy as jnp
import torch

from video_llava_tpu.models import bert as jbert
from video_llava_tpu.models.grounding_dino import (
    generate_text_masks as j_masks,
)
from video_llava_tpu_torch.models import bert as tbert
from video_llava_tpu_torch.models.grounding_dino import generate_text_masks
from torch_grounding_pair import META, dino_pair, to_port


def test_bert_block_diagonal_matches_jax():
    jp, _ = dino_pair()
    params = jp["text_backbone"]
    cfg = jbert.BertConfig.tiny_test()
    tp = to_port(params, tbert.init_params(META, tbert.BertConfig.tiny_test()))
    ids = np.asarray([[101, 5, 6, 1012, 7, 8, 9, 1012, 102, 0],
                      [101, 30, 1029, 31, 32, 33, 1012, 40, 41, 102]])
    self_mask, pos = generate_text_masks(ids)
    want_mask, want_pos = j_masks(ids)
    np.testing.assert_array_equal(self_mask, want_mask)
    np.testing.assert_array_equal(pos, want_pos)
    bias = np.where(self_mask[:, None], 0.0, -1e9).astype(np.float32)
    attn = np.ones_like(ids)
    attn[0, -1] = 0  # padding
    want = jbert.forward(params, jnp.asarray(ids), jnp.asarray(attn), cfg,
                         attention_bias=jnp.asarray(bias),
                         position_ids=jnp.asarray(pos))
    got = tbert.forward(tp, torch.from_numpy(ids), torch.from_numpy(attn),
                        tbert.BertConfig.tiny_test(),
                        attention_bias=torch.from_numpy(bias),
                        position_ids=torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    # no bias, default positions
    want = jbert.forward(params, jnp.asarray(ids), None, cfg)
    got = tbert.forward(tp, torch.from_numpy(ids), None,
                        tbert.BertConfig.tiny_test())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
