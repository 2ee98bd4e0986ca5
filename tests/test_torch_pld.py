"""Port parity: prompt-lookup speculative generation."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import torch

from video_llava_tpu.config import (
    GenerationConfig,
    LlamaConfig,
    VideoLLaVAConfig,
)
from video_llava_tpu.engine.speculative import generate_pld as jax_pld
from video_llava_tpu.models import video_llava as jax_vl
from video_llava_tpu_torch.engine.convert import params_from_jax
from video_llava_tpu_torch.engine.generate import (
    generate,
    generate_with_keywords,
)


def test_greedy_pld_matches_plain_greedy_and_jax():
    """Tiny f32 model (vocab 512), f32 cache, greedy. A batch of two
    ragged prompts, one strongly repetitive (long accepted drafts) and
    one random, 24 new tokens with ngram 2, k 4: the port's speculative
    generate equals its plain greedy generate and the JAX package's
    generate_pld, token for token and in lengths, with fewer verify
    forwards than tokens (drafts were accepted); then again with a stop
    id that greedy emits mid-answer, so row 0 ends early.
    generate_with_keywords(speculative=True) in chunks of 7 gives the
    same tokens as one plain run."""
    cfg = dataclasses.replace(VideoLLaVAConfig.tiny(),
                              llm=LlamaConfig.tiny(vocab_size=512),
                              vid_patch_token_id=509, vid_start_token_id=510,
                              vid_end_token_id=511)
    params = jax_vl.init_params(jax.random.PRNGKey(5), cfg, jnp.float32)
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg)
    rng = np.random.default_rng(2)
    pattern = list(rng.integers(2, 500, size=4))
    ids = np.zeros((2, 40), np.int32)
    ids[0] = pattern * 10
    ids[1, :29] = rng.integers(2, 500, size=29)
    lens = np.array([40, 29], np.int32)
    gen = GenerationConfig(max_new_tokens=24, do_sample=False,
                           eos_token_id=1, pad_token_id=0)
    forward, verifies = model.llm.forward, []

    def counted(*a, **kw):
        verifies.append(1)
        return forward(*a, **kw)

    for g in (gen, None):
        if g is None:  # stop at what row 0 emits at step 9
            g = dataclasses.replace(gen, eos_token_id=int(plain.tokens[0, 9]))
        want = jax_pld(params, cfg, g, jnp.asarray(ids), jnp.asarray(lens),
                       None, ngram=2, k=4, cache_dtype=jnp.float32)
        verifies.clear()
        model.llm.forward = counted
        spec = generate(model, g, torch.from_numpy(ids),
                        torch.from_numpy(lens), None,
                        cache_dtype=torch.float32, speculative=True,
                        spec_ngram=2, spec_k=4)
        del model.llm.forward
        if g is gen:  # drafts were accepted: fewer verifies than tokens
            assert len(verifies) < 23, len(verifies)
        plain = generate(model, g, torch.from_numpy(ids),
                         torch.from_numpy(lens), None,
                         cache_dtype=torch.float32)
        for got in (spec, plain):
            np.testing.assert_array_equal(got.tokens.numpy(),
                                          np.asarray(want.tokens))
            np.testing.assert_array_equal(got.lengths.numpy(),
                                          np.asarray(want.lengths))
    assert int(spec.lengths[0]) < 24  # row 0 stopped at the new stop id

    text, res = generate_with_keywords(
        model, gen, torch.from_numpy(ids[1:, :29]), torch.tensor([29]),
        None, None, decode_fn=lambda t: " ".join(map(str, t)),
        keyword_check_every=7, cache_dtype=torch.float32, speculative=True,
        spec_ngram=2, spec_k=4)
    one = generate(model, gen, torch.from_numpy(ids[1:, :29]),
                   torch.tensor([29]), None, cache_dtype=torch.float32)
    assert res.tokens[0].tolist() == one.tokens[0].tolist()
    assert text == " ".join(map(str, one.tokens[0].tolist()))
