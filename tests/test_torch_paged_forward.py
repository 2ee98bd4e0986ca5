"""Port parity: the LLaMA forward and decode over the paged KV cache."""

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


def test_paged_forward_matches_slot_and_jax():
    """LlamaConfig.tiny(), f32 params, two rows of 12 prompt tokens, then
    6 decode steps that cross block boundaries (positions 12 -> 18,
    blocks of 4), through a pool of 17 blocks with scrambled, disjoint
    tables. Port paged against port slot cache (same values, the same
    attention over a gathered view of the same length): 1e-5. Port
    paged against JAX paged: 1e-4 with an f32 cache (f32 in another
    summation order through 4 layers), 5e-3 with an int8 cache (a value
    next to a rounding boundary can quantize one step apart, as in
    test_torch_llama)."""
    cfg = dataclasses.replace(VideoLLaVAConfig.tiny(),
                              llm=LlamaConfig.tiny(vocab_size=256))
    params = jax_vl.init_params(jax.random.PRNGKey(0), cfg, jnp.float32)
    llm = params_from_jax(jax.tree.map(np.asarray, params), cfg).llm
    jp = params["llm"]
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 256, size=(2, 12)).astype(np.int32)
    lens = np.full((2,), 12, np.int32)
    table = np.array([[3, 7, 1, 12, 5, 9, 2, 14],
                      [4, 8, 6, 13, 10, 11, 15, 16]], np.int32)

    for jdt, tdt, tol in ((jnp.float32, torch.float32, 1e-4),
                          (jnp.int8, torch.int8, 5e-3)):
        jcache = jax_llama.PagedKVCache.create(
            cfg.llm, 2, num_blocks=17, block_size=4, max_blocks_per_row=8,
            dtype=jdt)._replace(table=jnp.asarray(table))
        paged = PagedKVCache.create(cfg.llm, 2, 17, 4, 8, tdt)
        paged.table = torch.from_numpy(table)
        slot = KVCache.create(cfg.llm, 2, 32, tdt)
        want, jcache = jax_llama.forward(
            jp, cfg.llm, input_ids=jnp.asarray(ids), cache=jcache,
            new_length=jnp.asarray(lens))
        got, paged = llm.forward(paged, input_ids=torch.from_numpy(ids),
                                 new_length=torch.from_numpy(lens))
        ref, slot = llm.forward(slot, input_ids=torch.from_numpy(ids),
                                new_length=torch.from_numpy(lens))
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=tol, rtol=tol)
        tok = ref[:, -1].argmax(-1).int()
        for _ in range(6):
            want, jcache = jax_llama.decode_step(
                jp, cfg.llm, jnp.asarray(tok.numpy()), jcache)
            got, paged = llm.decode_step(tok, paged)
            ref, slot = llm.decode_step(tok, slot)
            np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=tol, rtol=tol)
            tok = ref.argmax(-1).int()
        np.testing.assert_array_equal(paged.length.numpy(), lens + 6)
        np.testing.assert_array_equal(paged.length.numpy(),
                                      np.asarray(jcache.length))
