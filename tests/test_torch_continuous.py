"""Port parity: the continuous-batching engine over the slot cache."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import torch

from video_llava_tpu.config import LlamaConfig, VideoLLaVAConfig
from video_llava_tpu.engine.continuous import (
    ContinuousEngine as JaxEngine,
    SlotRequest as JaxRequest,
)
from video_llava_tpu.models import video_llava as jax_vl
from video_llava_tpu.runtime.tokenizer import ByteTokenizer
from video_llava_tpu_torch.config import GenerationConfig
from video_llava_tpu_torch.engine.continuous import (
    ContinuousEngine,
    SlotRequest,
)
from video_llava_tpu_torch.engine.convert import params_from_jax
from video_llava_tpu_torch.engine.generate import generate

ENGINE = dict(num_slots=2, max_cache_len=128, chunk=4, prompt_pad=16,
              prefill_chunk=16)


def tiny():
    """tests/test_continuous.py's model: 2 layers, width 64, 4 heads of
    16, vocab 512, f32, with its JAX parameters."""
    tok = ByteTokenizer()
    cfg = dataclasses.replace(
        VideoLLaVAConfig.tiny(),
        llm=dataclasses.replace(
            LlamaConfig.tiny(vocab_size=512), num_layers=2, hidden_size=64,
            intermediate_size=128, num_heads=4, num_kv_heads=4, head_dim=16),
        vid_patch_token_id=tok.vid_patch_token_id,
        vid_start_token_id=tok.vid_start_token_id,
        vid_end_token_id=tok.vid_end_token_id)
    params = jax_vl.init_params(jax.random.PRNGKey(0), cfg, jnp.float32)
    return cfg, tok, params, params_from_jax(
        jax.tree.map(np.asarray, params), cfg)


def plain_greedy(model, tok, ids, max_new, feats=None):
    """The port's one-shot greedy generate, cut at eos."""
    g = GenerationConfig(max_new_tokens=max_new, do_sample=False,
                         eos_token_id=tok.eos_token_id,
                         pad_token_id=tok.pad_token_id)
    r = generate(model, g, torch.tensor([ids]), torch.tensor([len(ids)]),
                 feats, cache_dtype=torch.float32)
    out = r.tokens[0, :int(r.lengths[0])].tolist()
    return out[:out.index(tok.eos_token_id)] if tok.eos_token_id in out \
        else out


def drain(eng, handles, max_iters=300):
    for _ in range(max_iters):
        if all(h.done for h in handles):
            return
        eng.step_once()
    raise AssertionError("engine did not finish")


def test_continuous_matches_jax_engine_and_plain_greedy():
    """Three staggered greedy requests (a repetitive one whose drafts are
    accepted, and prompts that span several 16-token prefill windows)
    through 2 slots of the f32 slot cache, speculation on: the port's
    engine gives the JAX ContinuousEngine's tokens and the port's plain
    greedy generate's, request for request; every chunk was speculative.
    Then a seeded sampled request joins two greedy ones: the greedy ones
    are unchanged, plain chunks ran, and the sampled one replays its
    tokens exactly when run alone."""
    cfg, tok, params, model = tiny()
    bos = tok.bos_token_id
    prompts = [[bos] + list(b"one two three four " * 3),
               [bos] + list(b"abc"),
               [bos] + list(b"the quick brown fox jumps over the dog")]
    want = [plain_greedy(model, tok, p, 12) for p in prompts]

    def run(engine_cls, request_cls, prm, **kw):
        eng = engine_cls(prm, cfg, cache_dtype=kw.pop("cache_dtype"),
                         **ENGINE, **kw)
        mk = lambda p: request_cls(p, max_new_tokens=12,  # noqa: E731
                                   eos_token_id=tok.eos_token_id)
        hs = [eng.submit(mk(prompts[0])), eng.submit(mk(prompts[1]))]
        eng.step_once()  # both admitted; the third arrives mid-flight
        hs.append(eng.submit(mk(prompts[2])))
        drain(eng, hs)
        return eng, [h.tokens for h in hs]

    jeng, jax_tokens = run(JaxEngine, JaxRequest, params,
                           cache_dtype=jnp.float32)
    eng, tokens = run(ContinuousEngine, SlotRequest, model,
                      cache_dtype=torch.float32)
    assert jax_tokens == want
    assert tokens == want
    assert eng.stats["plain_chunks"] == 0 and eng.stats["spec_chunks"] > 0
    assert eng.stats["spec_tokens"] >= sum(map(len, want)) - 3

    sampled = SlotRequest([bos] + list(b"sampled row"), max_new_tokens=10,
                          temperature=0.9, top_p=0.9, seed=42,
                          eos_token_id=tok.eos_token_id)
    eng = ContinuousEngine(model, cfg, cache_dtype=torch.float32,
                           **{**ENGINE, "num_slots": 3})
    hs = [eng.submit(SlotRequest(p, max_new_tokens=12,
                                 eos_token_id=tok.eos_token_id))
          for p in prompts[:2]] + [eng.submit(sampled)]
    drain(eng, hs)
    assert [h.tokens for h in hs[:2]] == want[:2]
    assert eng.stats["plain_chunks"] > 0
    alone = ContinuousEngine(model, cfg, cache_dtype=torch.float32, **ENGINE)
    h = alone.submit(sampled)
    drain(alone, [h])
    assert h.tokens == hs[2].tokens and len(h.tokens) > 0
