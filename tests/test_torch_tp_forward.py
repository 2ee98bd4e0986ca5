"""Tensor parallel over 2 gloo ranks on the CPU against the JAX
package's sharded forward on its virtual CPU mesh (make_mesh(1, 2)),
on tests/test_sharding.py's tiny f32 configuration and batch: the
video encode (CLIP with 2 of its 4 heads a rank through the attention
kernel's plain version, o and fc2 summed over 'model'; pooling whole
on every rank) within 1e-5, and the multimodal forward's logits within
tests/test_sharding.py's 2e-4; the ranks' greedy tokens (prefill into
an f32 cache, then decode) equal the unsharded port's."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from torch_tp_pair import forward_worker, greedy_gen, run_ranks, tiny_cfg
from video_llava_tpu.config import LlamaConfig, VideoLLaVAConfig
from video_llava_tpu.models import video_llava as jvl
from video_llava_tpu.parallel import make_mesh, shard_params
from video_llava_tpu.parallel import videollava_param_specs
from video_llava_tpu_torch.engine.convert import params_from_jax
from video_llava_tpu_torch.engine.generate import generate


def _jcfg():
    import dataclasses

    return dataclasses.replace(
        VideoLLaVAConfig.tiny(),
        llm=LlamaConfig(vocab_size=512, hidden_size=64,
                        intermediate_size=128, num_layers=2, num_heads=8,
                        num_kv_heads=8, head_dim=8,
                        max_position_embeddings=512),
        vid_patch_token_id=259, vid_start_token_id=260,
        vid_end_token_id=261)


def _batch(cfg, b=2, s=160):
    rng = np.random.default_rng(0)
    n = cfg.video_token_len
    ids = rng.integers(0, 256, size=(b, s))
    ids[:, 4:4 + n] = cfg.vid_patch_token_id
    feats = rng.normal(size=(b, n, cfg.vision.hidden_size)).astype(
        np.float32)
    pixels = rng.normal(size=(4, 56, 56, 3)).astype(np.float32)
    return ids, feats, pixels


def test_tp_forward_matches_jax(tmp_path):
    cfg = _jcfg()
    params = jax.jit(lambda k: jvl.init_params(k, cfg, jnp.float32))(
        jax.random.PRNGKey(0))
    ids, feats, pixels = _batch(cfg)
    lens = np.asarray([160, 153], np.int32)
    mesh = make_mesh(1, 2)
    sharded = shard_params(params, videollava_param_specs(params), mesh)
    want_logits = np.asarray(jax.jit(
        lambda p, i, f: jvl.forward(p, cfg, i, f)[0])(
            sharded, jnp.asarray(ids), jnp.asarray(feats)))
    want_enc = np.asarray(jax.jit(lambda p, x: jvl.encode_video(p, x, cfg))(
        sharded, jnp.asarray(pixels)))

    tree = jax.tree.map(np.asarray, params)
    out = run_ranks(forward_worker, 2, tmp_path, tree, tiny_cfg(), ids,
                    feats, lens, 8, pixels)
    assert (out["heads"], out["vision_heads"]) == (4, 2)
    np.testing.assert_allclose(out["enc"], want_enc, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out["logits"], want_logits, rtol=2e-4,
                               atol=2e-4)

    model = params_from_jax(tree, tiny_cfg())
    torch.set_num_threads(1)
    with torch.inference_mode():
        ref = generate(model, greedy_gen(8), torch.from_numpy(ids),
                       torch.from_numpy(lens), torch.from_numpy(feats),
                       cache_dtype=torch.float32)
    np.testing.assert_array_equal(out["tokens"], ref.tokens.numpy())
    np.testing.assert_array_equal(out["lengths"], ref.lengths.numpy())
