"""Port parity: LLaMA prefill into a KV cache, then cached decode."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import torch

from video_llava_tpu.config import LlamaConfig, VideoLLaVAConfig
from video_llava_tpu.models import llama as jax_llama
from video_llava_tpu.models import video_llava as jax_vl
from video_llava_tpu_torch.engine.convert import params_from_jax
from video_llava_tpu_torch.models.llama import KVCache


def test_prefill_and_decode_match_jax():
    """LlamaConfig.tiny(), f32 params, two right-padded rows. Prefill
    logits and cache contents, then 8 decode steps' logits, for an f32
    cache and an int8 cache. f32 math in another summation order through
    4 layers: with the f32 cache, logits (|logit| < 10) agree to 1e-4.
    The int8 cache quantizes k/v that already differ by ~1e-6, so a value
    next to a rounding boundary can land one step (absmax/127) apart:
    about 0.06% of entries at this seed, moving logits by up to ~2e-3,
    hence 5e-3 there."""
    cfg = dataclasses.replace(VideoLLaVAConfig.tiny(),
                              llm=LlamaConfig.tiny(vocab_size=512))
    params = jax_vl.init_params(jax.random.PRNGKey(0), cfg, jnp.float32)
    llm = params_from_jax(jax.tree.map(np.asarray, params), cfg).llm
    jp = params["llm"]
    rng = np.random.default_rng(0)
    b, s, max_len = 2, 24, 40
    ids = rng.integers(0, 512, size=(b, s)).astype(np.int32)
    lens = np.array([24, 19], np.int32)
    steps = rng.integers(0, 512, size=(8, b)).astype(np.int32)

    for jdt, tdt, tol in ((jnp.float32, torch.float32, 1e-4),
                          (jnp.int8, torch.int8, 5e-3)):
        jcache = jax_llama.KVCache.create(cfg.llm, b, max_len, jdt)
        want, jcache = jax_llama.forward(
            jp, cfg.llm, input_ids=jnp.asarray(ids), cache=jcache,
            new_length=jnp.asarray(lens))
        tcache = KVCache.create(cfg.llm, b, max_len, tdt)
        got, tcache = llm.forward(tcache, input_ids=torch.from_numpy(ids),
                                  new_length=torch.from_numpy(lens))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=tol, rtol=tol)
        np.testing.assert_array_equal(tcache.length.numpy(), lens)
        if tdt == torch.int8:
            # values next to a rounding boundary may land one step apart
            assert np.mean(tcache.k.numpy() != np.asarray(jcache.k)) < 1e-3
            # scales follow max|k|, which agrees to 1e-5 as in f32
            np.testing.assert_allclose(tcache.k_scale.numpy(),
                                       np.asarray(jcache.k_scale),
                                       atol=1e-5, rtol=0)
        else:
            np.testing.assert_allclose(tcache.k.numpy(),
                                       np.asarray(jcache.k), atol=1e-5)
            np.testing.assert_allclose(tcache.v.numpy(),
                                       np.asarray(jcache.v), atol=1e-5)
        for tok in steps:
            want, jcache = jax_llama.decode_step(jp, cfg.llm,
                                                 jnp.asarray(tok), jcache)
            got, tcache = llm.decode_step(torch.from_numpy(tok), tcache)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=tol, rtol=tol)
        np.testing.assert_array_equal(tcache.length.numpy(), lens + 8)
