"""Autoregressive generation: prefill + decode loop.

Counterpart of video_llava_tpu/engine/generate.py without speculative
decoding or a device mesh. The decode loop is a Python loop of
``decode_step`` calls; sampling draws from an explicit
``torch.Generator``. Loop rules kept from the JAX package: stop ids end
a row, a finished row emits the pad id and keeps its cache length, and
keyword stops are checked on the host between chunks of
``keyword_check_every`` tokens.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from video_llava_tpu_torch.config import GenerationConfig
from video_llava_tpu_torch.models.llama import KVCache


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
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """logits (b, vocab) f32 -> (b,) int32: argmax when greedy, else a
    draw from the processed distribution with `generator`."""
    if not gen.do_sample or gen.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(process_logits(logits, gen), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


class GenerateResult(NamedTuple):
    tokens: torch.Tensor  # (b, max_new_tokens) int32, pad after stop
    lengths: torch.Tensor  # (b,) int32 generated tokens incl. the stop
    cache: KVCache


def _decode_loop(model, gen: GenerationConfig, first_logits: torch.Tensor,
                 cache: KVCache, generator: Optional[torch.Generator],
                 max_new_tokens: int) -> GenerateResult:
    """Sample from first_logits, then decode up to max_new_tokens tokens
    in all; updates `cache` in place."""
    device = first_logits.device
    b = first_logits.shape[0]
    stop_ids = torch.tensor((gen.eos_token_id,) + tuple(gen.stop_token_ids),
                            dtype=torch.int32, device=device)
    tok = sample_token(first_logits, gen, generator)
    done = torch.isin(tok, stop_ids)
    buf = torch.full((b, max_new_tokens), gen.pad_token_id,
                     dtype=torch.int32, device=device)
    buf[:, 0] = tok
    lens = torch.ones((b,), dtype=torch.int32, device=device)
    step = 1
    while step < max_new_tokens and not bool(done.all()):
        old_length = cache.length
        logits, cache = model.llm.decode_step(tok, cache)
        nxt = sample_token(logits, gen, generator)
        nxt = torch.where(done, torch.full_like(nxt, gen.pad_token_id), nxt)
        buf[:, step] = nxt
        lens += (~done).to(torch.int32)
        # rows already done must not advance their cache length
        cache.length = torch.where(done, old_length, cache.length)
        done = done | torch.isin(nxt, stop_ids)
        tok = nxt
        step += 1
    return GenerateResult(tokens=buf, lengths=lens, cache=cache)


def generate(model, gen: GenerationConfig, input_ids: torch.Tensor,
             seq_lens: torch.Tensor, video_features: Optional[torch.Tensor],
             generator: Optional[torch.Generator] = None,
             max_cache_len: Optional[int] = None,
             cache_dtype=torch.bfloat16) -> GenerateResult:
    """Prefill a right-padded batch and decode up to max_new_tokens."""
    s = input_ids.shape[1]
    if max_cache_len is None:
        max_cache_len = s + gen.max_new_tokens
    res = model.prefill(input_ids, seq_lens, video_features, max_cache_len,
                        cache_dtype)
    return _decode_loop(model, gen, res.logits_last, res.cache, generator,
                        gen.max_new_tokens)


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
) -> Tuple[str, GenerateResult]:
    """Generation with the reference's keyword stopping
    (model/utils.py:6-26): stop when a decoded keyword appears; the
    text from the keyword on is dropped and the rest stripped. Batch
    size 1. (The JAX version's streaming callback is not ported yet.)
    """
    if input_ids.shape[0] != 1:
        raise ValueError("keyword stopping is per-conversation (batch 1)")
    s = input_ids.shape[1]
    if max_cache_len is None:
        max_cache_len = s + gen.max_new_tokens
    pre = model.prefill(input_ids, seq_lens, video_features, max_cache_len,
                        cache_dtype)
    logits, cache = pre.logits_last, pre.cache

    pieces: list = []
    text = ""
    remaining = gen.max_new_tokens
    while remaining > 0:
        chunk = min(keyword_check_every, remaining)
        out = _decode_loop(model, gen, logits, cache, generator, chunk)
        n = int(out.lengths[0])
        toks = out.tokens[0, :n].tolist()
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
        # continue from the chunk's last token (the JAX version also takes
        # this step after the last chunk, where nothing reads its logits)
        cache = out.cache
        logits, cache = model.llm.decode_step(out.tokens[:, n - 1], cache)

    return text.strip(), GenerateResult(
        tokens=torch.tensor([pieces], dtype=torch.int32),
        lengths=torch.tensor([len(pieces)], dtype=torch.int32),
        cache=cache,
    )
