"""Port parity: the continuous-batching engine over the paged KV pool,
with prefix caching and a video request."""

import jax.numpy as jnp
import numpy as np
import torch

from test_torch_continuous import ENGINE, drain, plain_greedy, tiny
from video_llava_tpu.engine.continuous import (
    ContinuousEngine as JaxEngine,
    SlotRequest as JaxRequest,
)
from video_llava_tpu_torch.engine.continuous import (
    ContinuousEngine,
    SlotRequest,
)
from video_llava_tpu_torch.models.llama import PagedKVCache

PAGED = dict(paged=True, block_size=16, prefix_cache=True, spec_k=4)


def test_paged_prefix_cache_and_video_match_jax_engine():
    """Paged pool of 16-token blocks, prefix caching and speculation on,
    f32 cache, in the port's engine and the JAX ContinuousEngine.

    Schedule 1, 2 slots: a first request fills the registry with its
    48-token prefix; then a second request with the same prefix (its
    prefill skips the shared blocks), a bystander, and a video request
    (features spliced at the <vid_patch> span, whole-window prefill) run
    concurrently. The hit row prefills in the step that admits it,
    before any decode chunk, so both engines give the same tokens, and
    both give the port's plain greedy (tests/test_torch_slice* hold that
    to the JAX package). prefix_hit_tokens is 48 in both; at the end
    every owned block is back in the free list, the registry's warm
    blocks have no refs, and every table row points at the pad block.

    Schedule 2, 3 slots: the hit row is admitted beside a 40-token
    prompt that takes the first prefill window, while a 16-token
    row decodes, so the hit row rides one decode chunk before its first
    window. The JAX engine leaves it at length 0 and that chunk's masked
    write lands in the shared prefix block (ROADMAP Queue 3): its hit
    row's tokens differ from plain greedy, and the port's, which starts
    the row at its skip, do not. The rows the fault does not touch
    agree in both engines."""
    cfg, tok, params, model = tiny()
    bos, eos = tok.bos_token_id, tok.eos_token_id
    prefix = list(b"shared system preamble with few-shot examples.. ")
    a = [bos] + prefix + list(b"question one?")
    b = [bos] + prefix + list(b"another ask")
    c = [bos] + list(b"bystander request")
    n_vid = cfg.video_token_len
    feats = np.random.default_rng(3).standard_normal(
        (n_vid, cfg.vision.hidden_size)).astype(np.float32)
    v = ([bos, tok.vid_start_token_id] + [tok.vid_patch_token_id] * n_vid
         + [tok.vid_end_token_id] + list(b" describe"))
    x = [bos] + list(b"count: 1 2 3 4")
    y = [bos] + list(b"a longer prompt that needs three windows")
    want = {p: plain_greedy(model, tok, list(p), n) for p, n in
            ((tuple(a), 8), (tuple(b), 8), (tuple(c), 8), (tuple(x), 40),
             (tuple(y), 8))}
    want[tuple(v)] = plain_greedy(model, tok, v, 8,
                                  torch.from_numpy(feats)[None])

    def engines(num_slots):
        kw = {**ENGINE, "max_cache_len": 512, "prompt_pad": 64,
              "num_slots": num_slots, **PAGED}
        return (JaxEngine(params, cfg, cache_dtype=jnp.float32, **kw),
                ContinuousEngine(model, cfg, cache_dtype=torch.float32,
                                 **kw))

    def schedule_1(eng, request_cls):
        mk = lambda p, **kw: request_cls(p, max_new_tokens=8,  # noqa: E731
                                         eos_token_id=eos, **kw)
        ha = eng.submit(mk(a))
        drain(eng, [ha])
        assert eng.stats["prefix_hit_tokens"] == 0
        hs = [ha, eng.submit(mk(b)), eng.submit(mk(c)),
              eng.submit(mk(v, video_features=feats))]
        drain(eng, hs)
        return [h.tokens for h in hs]

    def schedule_2(eng, request_cls):
        mk = lambda p, n=8: request_cls(p, max_new_tokens=n,  # noqa: E731
                                        eos_token_id=eos)
        drain(eng, [eng.submit(mk(a))])
        hx = eng.submit(mk(x, 40))
        eng.step_once()  # x prefilled and decoding in slot 0
        hy, hb = eng.submit(mk(y)), eng.submit(mk(b))
        eng.step_once()  # y's first window; b rides the decode chunk
        drain(eng, [hx, hy, hb])
        return [h.tokens for h in (hx, hy, hb)]

    jeng, eng = engines(2)
    assert isinstance(eng.cache, PagedKVCache)
    jax_tokens = schedule_1(jeng, JaxRequest)
    tokens = schedule_1(eng, SlotRequest)
    assert jax_tokens == tokens == [want[tuple(p)] for p in (a, b, c, v)]
    assert eng.stats["prefix_hit_tokens"] == 48  # 3 blocks of 16
    assert jeng.stats["prefix_hit_tokens"] == 48
    assert eng.stats["spec_chunks"] > 0
    owned = sum(map(len, eng.slot_owned)) + sum(map(len, eng.slot_shared))
    assert owned == 0 and all(s is None for s in eng.slots)
    warm = set(eng.prefix.refs)
    assert all(r == 0 for r in eng.prefix.refs.values())
    assert not warm & set(eng.alloc.free)
    assert sorted(warm | set(eng.alloc.free)) == list(
        range(1, eng.alloc.capacity + 1))
    assert int(eng.cache.table.abs().sum()) == 0

    jeng, eng = engines(3)
    jax_tokens = schedule_2(jeng, JaxRequest)
    tokens = schedule_2(eng, SlotRequest)
    assert eng.stats["prefix_hit_tokens"] == 48
    assert jeng.stats["prefix_hit_tokens"] == 48
    assert tokens == [want[tuple(p)] for p in (x, y, b)]
    assert jax_tokens[:2] == tokens[:2]
    assert jax_tokens[2] != tokens[2]
