"""Prompt-lookup speculative decoding (PLD), greedy-exact.

Counterpart of video_llava_tpu/engine/speculative.py. Decode reads every
weight to produce one token per row; PLD drafts the next k tokens for
free, as the continuation of the most recent earlier occurrence of the
context's trailing n-gram, and checks them in one (k+1)-token forward,
so one pass over the weights can emit several tokens. Greedy requests
emit exactly the plain greedy continuation (up to argmax ties, which
the verify forward's other summation order can break differently);
sampled requests keep the distribution through speculative rejection
sampling against the deterministic draft (:func:`accept_tokens`).

PyTorch idiom for the JAX loop: ``lax.while_loop`` is a Python loop of
fixed-width verify forwards (every iteration feeds the same (b, k+1)
shape: the last token plus k drafts, padded when a draft is short);
``vmap`` is a batch dimension; the PRNG key is an explicit
``torch.Generator``. The KV cache is written for all k+1 fed positions
and rewound by setting ``length`` back to the accepted prefix; stale
entries past ``length`` are masked by the attention reads and
overwritten by the next write.
"""

from __future__ import annotations

from typing import Optional

import torch

from video_llava_tpu_torch.config import GenerationConfig
from video_llava_tpu_torch.engine.generate import (
    GenerateResult,
    process_logits,
    sample_token,
)


def write_rows(dst: torch.Tensor, vals: torch.Tensor,
               pos: torch.Tensor) -> None:
    """dst[i, pos_i : pos_i + n] = vals[i] for every row, in place, with
    the start clamped to [0, W - n] as jax.lax.dynamic_update_slice
    clamps it. dst (b, W), vals (b, n), pos (b,) int."""
    n = vals.shape[1]
    start = pos.to(dst.device).long().clamp(0, dst.shape[1] - n)
    cols = start[:, None] + torch.arange(n, device=dst.device)[None]
    dst.scatter_(1, cols, vals.to(dst.dtype))


def find_draft(ctx: torch.Tensor, ctx_len: torch.Tensor, ngram: int,
               k: int):
    """Most-recent-match prompt lookup, per row.

    ctx: (b, C) int context (prompt + accepted tokens), valid in
    [0, ctx_len); ctx_len: (b,). The trailing `ngram` tokens (ending at
    ctx_len - 1) are matched against every earlier window; returns
    (draft (b, k) int32, draft_len (b,) int32), the continuation after
    the most recent match, clipped to the known context; draft_len is 0
    without a match or when the context is shorter than ngram + 1.
    Slices clamp as jax.lax.dynamic_slice does.
    """
    b, c = ctx.shape
    dev = ctx.device
    ctx_len = ctx_len.to(dev).long()
    idx = torch.arange(c, device=dev)
    tail_at = (ctx_len - ngram).clamp(0, c - ngram)[:, None]
    tail = torch.gather(ctx, 1, tail_at + torch.arange(ngram, device=dev))
    # eq[:, j]: ctx[j : j + ngram] == tail (windows past C wrap around and
    # are masked out by the bound below)
    eq = torch.ones((b, c), dtype=torch.bool, device=dev)
    for i in range(ngram):
        eq &= torch.roll(ctx, -i, dims=1) == tail[:, i:i + 1]
    # the window must end before the trailing n-gram starts
    valid = eq & (idx[None] < (ctx_len - 2 * ngram + 1)[:, None])
    j = torch.where(valid, idx[None], -1).amax(dim=1)
    has = (j >= 0) & (ctx_len >= ngram + 1)
    start = torch.where(has, j + ngram, 0).clamp_min(0)
    at = start.clamp(max=c - k)[:, None] + torch.arange(k, device=dev)
    draft = torch.gather(ctx, 1, at).to(torch.int32)
    draft_len = torch.where(has, torch.minimum(ctx_len - start,
                                               torch.full_like(start, k)), 0)
    return draft, draft_len.to(torch.int32)


def accept_tokens(logits: torch.Tensor, draft: torch.Tensor,
                  draft_len: torch.Tensor, gen: GenerationConfig,
                  generator: Optional[torch.Generator] = None):
    """Speculative acceptance for a deterministic (prompt-lookup) draft,
    per row.

    logits: (b, k+1, vocab) raw logits at the fed positions; draft (b,
    k). Returns (m (b,), z (b,)): the accepted prefix length of each
    draft and the token emitted at position m (the model's own token at
    the first rejected position, or the bonus token after a fully
    accepted draft). Greedy: accept while draft == argmax, z = argmax.
    Sampled: accept d_i with probability p_i(d_i); on a rejection draw
    from p_i with the draft token masked out (the residual of a one-hot
    draft), so each emitted token has the law of plain sampling.
    """
    b, k1, vocab = logits.shape
    k = k1 - 1
    dev = logits.device
    ar = torch.arange(k, device=dev)
    draft = draft.long()
    rows = torch.arange(b, device=dev)
    stop = torch.zeros((b, 1), dtype=torch.bool, device=dev)

    def first_rejected(ok):  # index of the first False, k if none
        return torch.cat([ok, stop], 1).int().argmin(dim=1)

    if not gen.do_sample or gen.temperature <= 0.0:
        g = logits.argmax(dim=-1)
        m = first_rejected((draft == g[:, :k]) & (ar < draft_len[:, None]))
        return m.to(torch.int32), g[rows, m].to(torch.int32)
    proc = process_logits(logits, gen)  # (b, k+1, vocab)
    logp = torch.log_softmax(proc[:, :k], dim=-1)
    p_draft = torch.gather(logp, 2, draft[:, :, None])[:, :, 0].exp()
    u = torch.rand((b, k), generator=generator, device=dev)
    ok = (u < p_draft) & (ar < draft_len[:, None])
    m = first_rejected(ok)
    rejected = m < draft_len
    row = proc[rows, m]  # (b, vocab)
    masked = torch.arange(vocab, device=dev)[None] == draft[
        rows, m.clamp(max=k - 1)][:, None]
    row = row.masked_fill(masked & rejected[:, None], float("-inf"))
    z = torch.multinomial(torch.softmax(row, dim=-1), 1,
                          generator=generator)[:, 0]
    return m.to(torch.int32), z.to(torch.int32)


def _init_ctx(input_ids: torch.Tensor, cap: int,
              pad_token_id: int) -> torch.Tensor:
    """Context buffer (b, cap) for the n-gram lookup: the prompt, then
    pad. cap must cover the prompt, every later emission and the k+1
    write overshoot."""
    b, s = input_ids.shape
    ctx = torch.full((b, cap), pad_token_id, dtype=torch.int32,
                     device=input_ids.device)
    ctx[:, :s] = input_ids
    return ctx


def _decode_loop_pld(model, gen: GenerationConfig,
                     first_logits: torch.Tensor, cache, ctx: torch.Tensor,
                     ctx_len: torch.Tensor,
                     generator: Optional[torch.Generator],
                     max_new_tokens: int, ngram: int, k: int):
    """Speculative decode loop over a batch, greedy or sampled; rows
    draft, accept and advance on their own (a finished row feeds tokens
    whose cache writes are rewound). The cache must hold cache.length +
    max_new_tokens + k + 1 positions. ctx/ctx_len (from :func:`_init_ctx`)
    are updated in place and returned, so a caller can resume the loop
    across host-side keyword checks. Returns (GenerateResult, ctx,
    ctx_len); the cache is updated in place.

    Each iteration is one llama forward of fixed shape (b, k+1); the
    loop's condition is read on the host once an iteration, where the
    JAX while_loop reads it on the device."""
    dev = first_logits.device
    b = first_logits.shape[0]
    ctx_len = ctx_len.to(device=dev, dtype=torch.int32)
    stop_ids = torch.tensor((gen.eos_token_id,) + tuple(gen.stop_token_ids),
                            dtype=torch.int32, device=dev)
    pad = gen.pad_token_id
    buf_cap = max_new_tokens + k + 1  # slack for the final overshoot
    ar = torch.arange(k + 1, device=dev)

    tok = sample_token(first_logits, gen, generator)  # (b,)
    done = torch.isin(tok, stop_ids)
    buf = torch.full((b, buf_cap), pad, dtype=torch.int32, device=dev)
    buf[:, 0] = tok
    write_rows(ctx, tok[:, None], ctx_len)
    n = torch.ones((b,), dtype=torch.int32, device=dev)
    ctx_len = ctx_len + 1

    while not bool((done | (n >= max_new_tokens)).all()):
        draft, draft_len = find_draft(ctx, ctx_len, ngram, k)
        fed = torch.cat([tok[:, None], draft], dim=1)  # (b, k+1)
        old_length = cache.length
        logits, cache = model.llm.forward(cache, input_ids=fed)
        m, z = accept_tokens(logits, draft, draft_len, gen, generator)
        # candidates: m accepted drafts, then z, then pad
        cand = torch.where(
            ar[None] < m[:, None],
            torch.gather(draft, 1, ar.clamp(max=k - 1)[None].expand(b, -1)),
            torch.where(ar[None] == m[:, None], z[:, None],
                        torch.full_like(z[:, None], pad)))
        is_stop = torch.isin(cand, stop_ids) & (ar[None] <= m[:, None])
        first_stop = torch.cat(
            [is_stop, torch.ones((b, 1), dtype=torch.bool, device=dev)],
            1).int().argmax(dim=1)
        hit = first_stop <= m
        n_new = torch.where(hit, first_stop + 1, m + 1)
        # finished rows emit nothing; every row stops at its budget
        n_new = torch.where(done, 0, torch.minimum(n_new,
                                                   max_new_tokens - n))
        cand = torch.where(ar[None] < n_new[:, None], cand,
                           torch.full_like(cand, pad))
        write_rows(buf, cand, n)
        write_rows(ctx, cand, ctx_len)
        # keep the cache entries of tok and the accepted drafts only
        keep = torch.where(done, 0, torch.minimum(1 + m, n_new))
        cache.length = (old_length + keep).to(torch.int32)
        last = torch.gather(cand, 1, (n_new - 1).clamp_min(0).long()[:, None])
        tok = torch.where(done, tok, last[:, 0])
        done = done | hit | (n + n_new >= max_new_tokens)
        n = (n + n_new).to(torch.int32)
        ctx_len = (ctx_len + n_new).to(torch.int32)
    n = n.clamp(max=max_new_tokens)
    keep_cols = torch.arange(buf_cap, device=dev)[None] < n[:, None]
    out = torch.where(keep_cols, buf, torch.full_like(buf, pad))
    return (GenerateResult(tokens=out[:, :max_new_tokens], lengths=n,
                           cache=cache), ctx, ctx_len)


def generate_pld(model, gen: GenerationConfig, input_ids: torch.Tensor,
                 seq_lens: torch.Tensor,
                 video_features: Optional[torch.Tensor],
                 generator: Optional[torch.Generator] = None,
                 ngram: int = 3, k: int = 8,
                 max_cache_len: Optional[int] = None,
                 cache_dtype=torch.bfloat16) -> GenerateResult:
    """Generation with prompt-lookup speculation, any batch size: the
    drop-in for engine/generate.generate (greedy-exact, sampling
    distribution-exact). An iteration costs one (b, k+1)-token forward."""
    b, s = input_ids.shape
    if max_cache_len is None:
        max_cache_len = s + gen.max_new_tokens + k + 1
    res = model.prefill(input_ids, seq_lens, video_features, max_cache_len,
                        cache_dtype)
    ctx = _init_ctx(input_ids, s + gen.max_new_tokens + k + 1,
                    gen.pad_token_id)
    out, _, _ = _decode_loop_pld(model, gen, res.logits_last, res.cache, ctx,
                                 seq_lens, generator, gen.max_new_tokens,
                                 ngram, k)
    return out


def generate_pld_text(model, gen: GenerationConfig, input_ids: torch.Tensor,
                      s_real: int, video_features: Optional[torch.Tensor],
                      generator: Optional[torch.Generator], tokenizer,
                      stop_str: Optional[str],
                      cache_dtype=torch.bfloat16) -> str:
    """Speculative generation of one row decoded to text with the
    reference's stop-string strip (shared by runtime.inference and
    serving). One device-to-host copy of the tokens."""
    out = generate_pld(
        model, gen, input_ids,
        torch.tensor([s_real], dtype=torch.int32, device=input_ids.device),
        video_features, generator=generator, cache_dtype=cache_dtype)
    toks = out.tokens[0].cpu()
    n = int(out.lengths[0])
    text = tokenizer.decode(toks[:n].tolist(), skip_special_tokens=True)
    text = text.strip()
    if stop_str and text.endswith(stop_str):
        text = text[: -len(stop_str)]
    return text.strip()
