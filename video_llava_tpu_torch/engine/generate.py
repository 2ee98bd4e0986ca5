"""Autoregressive generation: prefill + decode loop.

Counterpart of video_llava_tpu/engine/generate.py. The decode loop is a
Python loop of ``decode_step`` calls, or with ``speculative`` the
prompt-lookup loop of engine/speculative.py; sampling draws from an
explicit ``torch.Generator``. Under a tensor-parallel mesh (the model's
`mesh`, or the `mesh` argument) every rank runs the same loop on the
same gathered logits: greedy tokens agree by construction, and a
sampled token is drawn on the mesh's first rank and broadcast, so the
ranks' generators need not agree. Speculation is ignored under a mesh,
as in the JAX package (generate.py:168, :238 there). Loop rules kept
from the JAX package: stop ids end a row, a finished row emits the pad
id and keeps its cache length, and keyword stops are checked on the
host between chunks of ``keyword_check_every`` tokens, which is also
where the streaming callback of ``generate_with_keywords`` is called.

With the span recorder on (utils/trace_tools), the plain loop records
``generate.prefill``, from the call's start to the loop's first read of
``done``, then one ``generate.decode_step`` a decode forward, each ended
by the next read (which waits for the step's kernels) or, for the last,
by the loop's return (``generate``) or by the chunk's copy of its tokens
to the host (``generate_with_keywords``, whose forward between chunks is
a step of its own; its keyword check lies in no span). A call that
raises records none of its open spans. The spans add no host
synchronisation.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from video_llava_tpu_torch.config import GenerationConfig
from video_llava_tpu_torch.models.llama import KVCache
from video_llava_tpu_torch.utils import trace_tools


def process_logits(logits: torch.Tensor,
                   gen: GenerationConfig) -> torch.Tensor:
    """Temperature scaling + top-p masking of (..., vocab) f32 logits;
    the softmax of the result is the sampling distribution."""
    scaled = logits / gen.temperature
    if gen.top_p < 1.0:
        sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep the smallest set with cumulative prob >= top_p
        cutoff_idx = ((cum - probs) < gen.top_p).sum(dim=-1) - 1
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx[..., None])
        scaled = scaled.masked_fill(scaled < cutoff, float("-inf"))
    return scaled


def sample_token(logits: torch.Tensor, gen: GenerationConfig,
                 generator: Optional[torch.Generator],
                 mesh=None) -> torch.Tensor:
    """logits (b, vocab) f32 -> (b,) int32: argmax when greedy, else a
    draw from the processed distribution with `generator` (under a
    mesh, the first rank's draw on every rank)."""
    if not gen.do_sample or gen.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(process_logits(logits, gen), dim=-1)
    tok = torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)
    return tok if mesh is None else mesh.broadcast_first(tok)


def tp_mesh(model, mesh=None):
    """The tensor-parallel mesh a generation runs under: `mesh`, else
    the model's; None for one rank."""
    mesh = mesh if mesh is not None else getattr(model, "mesh", None)
    return mesh if mesh is not None and mesh.size > 1 else None


class GenerateResult(NamedTuple):
    tokens: torch.Tensor  # (b, max_new_tokens) int32, pad after stop
    lengths: torch.Tensor  # (b,) int32 generated tokens incl. the stop
    cache: KVCache


def _decode_loop(model, gen: GenerationConfig, first_logits: torch.Tensor,
                 cache: KVCache, generator: Optional[torch.Generator],
                 max_new_tokens: int, span=None):
    """Sample from first_logits, then decode up to max_new_tokens tokens
    in all; updates `cache` in place. `span`: the caller's open span
    (utils/trace_tools), which the first read of `done` ends. Returns
    the GenerateResult and the span still open (the last step's, else
    `span`), for the caller to end."""
    device = first_logits.device
    b = first_logits.shape[0]
    stop_ids = torch.tensor((gen.eos_token_id,) + tuple(gen.stop_token_ids),
                            dtype=torch.int32, device=device)
    mesh = tp_mesh(model)
    tok = sample_token(first_logits, gen, generator, mesh)
    done = torch.isin(tok, stop_ids)
    buf = torch.full((b, max_new_tokens), gen.pad_token_id,
                     dtype=torch.int32, device=device)
    buf[:, 0] = tok
    lens = torch.ones((b,), dtype=torch.int32, device=device)
    step = 1
    while step < max_new_tokens and not bool(done.all()):
        span = trace_tools.switch(span, "generate.decode_step")
        old_length = cache.length
        logits, cache = model.llm.decode_step(tok, cache)
        nxt = sample_token(logits, gen, generator, mesh)
        nxt = torch.where(done, torch.full_like(nxt, gen.pad_token_id), nxt)
        buf[:, step] = nxt
        lens += (~done).to(torch.int32)
        # rows already done must not advance their cache length
        cache.length = torch.where(done, old_length, cache.length)
        done = done | torch.isin(nxt, stop_ids)
        tok = nxt
        step += 1
    return GenerateResult(tokens=buf, lengths=lens, cache=cache), span


@trace_tools.unwinding
def generate(model, gen: GenerationConfig, input_ids: torch.Tensor,
             seq_lens: torch.Tensor, video_features: Optional[torch.Tensor],
             generator: Optional[torch.Generator] = None,
             max_cache_len: Optional[int] = None,
             cache_dtype=torch.bfloat16, speculative: bool = False,
             spec_ngram: int = 3, spec_k: int = 8,
             mesh=None) -> GenerateResult:
    """Prefill a right-padded batch and decode up to max_new_tokens.

    speculative: decode through prompt-lookup speculation
    (engine/speculative.py; rows draft and advance on their own), with
    spec_k + 1 more cache rows for the verify forward's overshoot.
    Ignored under a tensor-parallel mesh (`mesh`, else the model's)."""
    speculative = speculative and tp_mesh(model, mesh) is None
    span = None if speculative else trace_tools.begin("generate.prefill")
    s = input_ids.shape[1]
    slack = spec_k + 1 if speculative else 0
    if max_cache_len is None:
        max_cache_len = s + gen.max_new_tokens + slack
    elif speculative:
        max_cache_len = max(max_cache_len, s + gen.max_new_tokens + slack)
    res = model.prefill(input_ids, seq_lens, video_features, max_cache_len,
                        cache_dtype)
    if speculative:
        from video_llava_tpu_torch.engine.speculative import (
            _decode_loop_pld,
            _init_ctx,
        )

        ctx = _init_ctx(input_ids, s + gen.max_new_tokens + spec_k + 1,
                        gen.pad_token_id)
        out, _, _ = _decode_loop_pld(model, gen, res.logits_last, res.cache,
                                     ctx, seq_lens, generator,
                                     gen.max_new_tokens, spec_ngram, spec_k)
        return out
    out, span = _decode_loop(model, gen, res.logits_last, res.cache,
                             generator, gen.max_new_tokens, span)
    trace_tools.end(span)
    return out


@trace_tools.unwinding
def generate_with_keywords(
    model,
    gen: GenerationConfig,
    input_ids: torch.Tensor,
    seq_lens: torch.Tensor,
    video_features: Optional[torch.Tensor],
    generator: Optional[torch.Generator],
    decode_fn: Callable[[Sequence[int]], str],
    keywords: Sequence[str] = (),
    keyword_check_every: int = 64,
    max_cache_len: Optional[int] = None,
    cache_dtype=torch.bfloat16,
    on_delta: Optional[Callable[[str], None]] = None,
    postprocess: Optional[Callable[[str], str]] = None,
    speculative: bool = False,
    spec_ngram: int = 3,
    spec_k: int = 8,
    mesh=None,
) -> Tuple[str, GenerateResult]:
    """Generation with the reference's keyword stopping
    (model/utils.py:6-26): decode in chunks of keyword_check_every
    tokens, stop when a decoded keyword appears, drop the text from the
    keyword on. Batch size 1.

    speculative: each chunk runs the prompt-lookup loop
    (engine/speculative.py) instead of plain decode.
    on_delta: streaming callback, called after each chunk with the newly
    final text; to never retract text it holds back len(longest
    keyword) - 1 characters until a chunk's check has passed, and the
    last call flushes the rest.
    postprocess: applied to the final text before the last delta and the
    return value, so the stream concatenates to the returned text
    (default str.strip); if it rewrites text already streamed, the raw
    remainder is flushed instead.
    mesh: speculation is ignored under a tensor-parallel mesh (this, else
    the model's).
    """
    if input_ids.shape[0] != 1:
        raise ValueError("keyword stopping is per-conversation (batch 1)")
    speculative = speculative and tp_mesh(model, mesh) is None
    span = None if speculative else trace_tools.begin("generate.prefill")
    s = input_ids.shape[1]
    if max_cache_len is None:
        max_cache_len = s + gen.max_new_tokens + (
            spec_k + 1 if speculative else 0)
    pre = model.prefill(input_ids, seq_lens, video_features, max_cache_len,
                        cache_dtype)
    logits, cache = pre.logits_last, pre.cache
    if speculative:
        from video_llava_tpu_torch.engine.speculative import (
            _decode_loop_pld,
            _init_ctx,
        )

        ctx = _init_ctx(input_ids, s + gen.max_new_tokens + spec_k + 1,
                        gen.pad_token_id)
        ctx_len = seq_lens

    pieces: list = []
    text = ""
    emitted = 0
    holdback = max((len(k) for k in keywords if k), default=1) - 1

    def emit(current: str, final: bool) -> None:
        nonlocal emitted
        if on_delta is None:
            return
        upto = len(current) if final else max(len(current) - holdback, 0)
        if upto > emitted:
            on_delta(current[emitted:upto])
            emitted = upto

    remaining = gen.max_new_tokens
    while remaining > 0:
        chunk = min(keyword_check_every, remaining)
        if speculative:
            out, ctx, ctx_len = _decode_loop_pld(
                model, gen, logits, cache, ctx, ctx_len, generator, chunk,
                spec_ngram, spec_k)
        else:
            out, span = _decode_loop(model, gen, logits, cache, generator,
                                     chunk, span)
        # one device-to-host copy of the chunk's tokens, which waits for
        # its last step: the step's span ends here
        toks_all = out.tokens[0].cpu()
        trace_tools.end(span)
        n = int(out.lengths[0])
        toks = toks_all[:n].tolist()
        pieces.extend(toks)
        remaining -= chunk
        text = decode_fn(pieces)
        stopped_by_id = n < chunk or (
            toks and toks[-1] in (gen.eos_token_id, *gen.stop_token_ids))
        kw_hit = next((k for k in keywords if k and k in text), None)
        if kw_hit is not None:
            text = text.split(kw_hit)[0]
            break
        if stopped_by_id or remaining == 0:
            break
        emit(text, final=False)
        # continue from the chunk's last token (the JAX version also takes
        # this step after the last chunk, where nothing reads its logits)
        cache = out.cache
        if not speculative:  # its span ends in the next chunk's loop
            span = trace_tools.begin("generate.decode_step")
        logits, cache = model.llm.decode_step(out.tokens[:, n - 1], cache)

    final = (postprocess or str.strip)(text)
    if on_delta is not None:
        if final.startswith(text[:emitted]):
            if len(final) > emitted:
                on_delta(final[emitted:])
        else:
            emit(text, final=True)
    return final, GenerateResult(
        tokens=torch.tensor([pieces], dtype=torch.int32),
        lengths=torch.tensor([len(pieces)], dtype=torch.int32),
        cache=cache,
    )
