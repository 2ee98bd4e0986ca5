"""Port parity for a grouped-query LLaMA: 4 query heads over 2 KV heads at
head dim 32, prefilled and decoded greedily through the stacked cache
and through the paged cache, port against the JAX package. The port's
decode steps fall through from the stacked and paged wrappers to the
flat dispatch (on the card: kernel 11); here each runs under 'auto' (the
plain reference) and under 'pallas' (kernel 11's plain version)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import torch

from video_llava_tpu.config import LlamaConfig, VideoLLaVAConfig
from video_llava_tpu.models import llama as jax_llama
from video_llava_tpu.models import video_llava as jax_vl
from video_llava_tpu_torch.engine.convert import params_from_jax
from video_llava_tpu_torch.models.llama import KVCache, PagedKVCache
from video_llava_tpu_torch.ops import attention

# f32 parameters and cache; f32 math in another summation order through
# 4 layers, as tests/test_torch_llama.py: logits (|logit| < 10) to 1e-4.
TOL = 1e-4
STEPS = 6


def test_gqa_llama_generates_as_jax():
    cfg = dataclasses.replace(
        VideoLLaVAConfig.tiny(),
        llm=dataclasses.replace(LlamaConfig.tiny(vocab_size=256),
                                hidden_size=128, intermediate_size=256,
                                num_heads=4, num_kv_heads=2, head_dim=32))
    params = jax_vl.init_params(jax.random.PRNGKey(1), cfg, jnp.float32)
    llm = params_from_jax(jax.tree.map(np.asarray, params), cfg).llm
    jp = params["llm"]
    assert llm.layers[0].wk.kernel.shape == (128, 2 * 32)
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 256, size=(2, 12)).astype(np.int32)
    lens = np.array([12, 9], np.int32)
    table = np.array([[3, 7, 1, 12, 5], [4, 8, 6, 2, 10]], np.int32)

    def jax_cache(paged):
        if not paged:
            return jax_llama.KVCache.create(cfg.llm, 2, 20, jnp.float32)
        return jax_llama.PagedKVCache.create(
            cfg.llm, 2, num_blocks=13, block_size=4, max_blocks_per_row=5,
            dtype=jnp.float32)._replace(table=jnp.asarray(table))

    def port_cache(paged):
        if not paged:
            return KVCache.create(cfg.llm, 2, 20, torch.float32)
        cache = PagedKVCache.create(cfg.llm, 2, 13, 4, 5, torch.float32)
        cache.table = torch.from_numpy(table)
        return cache

    for paged in (False, True):
        want, jcache = jax_llama.forward(
            jp, cfg.llm, input_ids=jnp.asarray(ids), cache=jax_cache(paged),
            new_length=jnp.asarray(lens))
        want_last = np.asarray(want)[np.arange(2), lens - 1]
        jtokens, jlogits = [], []
        for _ in range(STEPS):
            tok = want_last.argmax(-1).astype(np.int32)
            jtokens.append(tok)
            want_last, jcache = jax_llama.decode_step(
                jp, cfg.llm, jnp.asarray(tok), jcache)
            want_last = np.asarray(want_last)
            jlogits.append(want_last)
        try:
            for impl in ("auto", "pallas"):
                attention.set_default_impl(impl)
                got, cache = llm.forward(port_cache(paged),
                                         input_ids=torch.from_numpy(ids),
                                         new_length=torch.from_numpy(lens))
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           atol=TOL, rtol=TOL)
                last = got.numpy()[np.arange(2), lens - 1]
                for step in range(STEPS):
                    tok = last.argmax(-1).astype(np.int32)
                    np.testing.assert_array_equal(tok, jtokens[step])
                    logits, cache = llm.decode_step(torch.from_numpy(tok),
                                                    cache)
                    last = logits.numpy()
                    np.testing.assert_allclose(
                        last, jlogits[step], atol=TOL, rtol=TOL,
                        err_msg=f"paged {paged} {impl} step {step}")
                np.testing.assert_array_equal(cache.length.numpy(),
                                              lens + STEPS)
        finally:
            attention.set_default_impl("auto")
