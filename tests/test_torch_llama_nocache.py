"""Port parity: the LLaMA forward without a KV cache (training's causal
self-attention through ops/attention.multi_head_attention), against the
JAX package's llama.forward(cache=None), and remat's gradients."""

import numpy as np
import jax.numpy as jnp
import torch

from video_llava_tpu.models import llama as jax_llama
from torch_train_pair import jax_params, port_model, tiny_cfg


def test_cacheless_forward_matches_jax_and_remat_keeps_gradients():
    """A GQA config (4 query heads over 2 kv heads), two rows of 40
    tokens: logits within 1e-4 of the JAX package's (f32 through two
    layers, |logit| < 10). Then the gradients of a loss for the input
    embeddings and two frozen-by-default weights (layer 0's wq, layer
    1's down projection): remat=True recomputes each layer in the
    backward pass and must give remat=False's gradients to 1e-6 of max
    |ref| (the same f32 ops, recomputed)."""
    cfg = tiny_cfg(num_kv_heads=2)
    params = jax_params(cfg)
    llm = port_model(params, cfg).llm
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.llm.vocab_size, size=(2, 40)).astype(np.int32)
    want, cache = jax_llama.forward(params["llm"], cfg.llm,
                                    input_ids=jnp.asarray(ids))
    assert cache is None
    got, cache = llm.forward(input_ids=torch.from_numpy(ids))
    assert cache is None and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)

    weights = [llm.layers[0].wq.kernel, llm.layers[1].down.kernel]
    target = torch.from_numpy(
        rng.standard_normal((2, 40, cfg.llm.vocab_size)).astype(np.float32))
    grads = []
    for remat in (False, True):
        embeds = llm.embed_tokens(torch.from_numpy(ids)).requires_grad_()
        for w in weights:
            w.requires_grad_()
        logits, _ = llm.forward(inputs_embeds=embeds, remat=remat)
        (logits * target).sum().backward()
        grads.append([embeds.grad] + [w.grad for w in weights])
        for w in weights:
            w.grad = None
    for a, b in zip(*grads):
        assert a is not None and b is not None
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0,
                                   atol=1e-6 * a.abs().max().item())
