"""Port: engine.convert carries a bf16 JAX tree bit for bit."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import torch

from video_llava_tpu.config import VideoLLaVAConfig
from video_llava_tpu.models import video_llava as jax_vl
from video_llava_tpu_torch.engine.convert import params_from_jax


def test_bf16_tree_carries_the_same_bytes():
    cfg = dataclasses.replace(VideoLLaVAConfig.tiny())
    params = jax_vl.init_params(jax.random.PRNGKey(1), cfg, jnp.bfloat16)
    tree = jax.tree.map(np.asarray, params)
    model = params_from_jax(tree, cfg)
    want = tree["vision"]["layers"]["q"]["kernel"][1]
    got = model.vision.layers[1].q.kernel
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))
