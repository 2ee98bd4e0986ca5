"""Slot-based continuous batching for serving.

Counterpart of video_llava_tpu/engine/continuous.py. The engine decodes
a fixed batch of B cache rows ("slots") and admits and retires requests
between chunks of decode steps:

  * one persistent cache of B rows lives on the device, either the slot
    cache (B x max_cache_len) or a paged pool of blocks shared through
    per-row block tables (``paged=True``, optionally with automatic
    prefix caching). A request is admitted by prefilling its row and
    retired by marking the row free; stale cells past a row's length are
    masked by cache.length;
  * a decode chunk runs ``chunk`` steps for all B rows (inactive rows
    keep their length); rows sample with their own temperature and
    top-p, each from its own ``torch.Generator`` seeded by the request,
    so a seeded request replays the same tokens whatever shares its
    batch (JAX's random bits are not reproduced: sampled tokens agree
    within the port only);
  * when every active row is greedy, a chunk runs prompt-lookup
    speculation instead (engine/speculative.py), ``chunk`` verify
    forwards of (B, k+1) tokens;
  * tokens stay on the device through a chunk and come back as one
    (B, chunk) copy, the JAX engine's rule of one device-to-host
    transfer per chunk; stop ids, max_tokens and substring stops are
    the host's concern.

The device programs are plain functions on tensors that update the
cache in place (JAX donates the buffers instead). Text prompts prefill
in fixed windows of ``prefill_chunk`` tokens, interleaved with decode
chunks; video prompts prefill whole, since the feature splice needs the
whole <vid_patch> span in one forward.

Under a tensor-parallel mesh (the model's, from
parallel/sharding.shard_params; ``mesh`` names it too) the engine is
built on every rank (parallel/driver.new) and its state changes only
through replicated calls: submit, each scheduler step and the
scheduler's failure backstop. Everything a step decides from is then
the same on every rank. A cancellation (the server's substring stop, a
streaming callback that fails) is latched: asked on rank 0 at any time,
it takes effect at the start of the next step, whose replicated call
carries the cancelled requests. The caches hold the local KV heads;
block tables and lengths are whole on every rank.
"""

from __future__ import annotations

import dataclasses
import hashlib
import heapq
import logging
import threading
from collections import OrderedDict
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from video_llava_tpu_torch.config import GenerationConfig, VideoLLaVAConfig
from video_llava_tpu_torch.engine.generate import tp_mesh
from video_llava_tpu_torch.engine.speculative import (
    accept_tokens,
    find_draft,
    write_rows,
)
from video_llava_tpu_torch.models.llama import KVCache, PagedKVCache
from video_llava_tpu_torch.parallel import driver
from video_llava_tpu_torch.parallel.sharding import shard_kv_cache

_GREEDY = GenerationConfig(do_sample=False, temperature=0.0)


# -- device programs ----------------------------------------------------------


def _slice_row(cache, slot: int):
    """Row `slot` as a b=1 cache. Its k/v (and scales) are views of the
    cache's storage, so writes through them land in place; its length
    is a copy. A paged row is the whole shared pool plus the row's table
    and length."""
    length = cache.length[slot:slot + 1].clone()
    if isinstance(cache, PagedKVCache):
        return dataclasses.replace(cache, length=length,
                                   table=cache.table[slot:slot + 1])
    row = lambda a: None if a is None else a[:, slot:slot + 1]  # noqa: E731
    return KVCache(k=row(cache.k), v=row(cache.v), length=length,
                   k_scale=row(cache.k_scale), v_scale=row(cache.v_scale))


def _insert_row(cache, rowc, slot: int):
    """Put a row view's length back (its k/v writes already landed in the
    cache's storage)."""
    cache.length[slot] = rowc.length[0]
    return cache


def _top_p_masked(logits: torch.Tensor, temps: Sequence[float],
                  top_ps: Sequence[float]) -> torch.Tensor:
    """Temperature-scaled logits (B, V) with every token outside each
    row's top-p set at -inf: the smallest set of most likely tokens whose
    probability reaches top_p (the JAX engine's _sample_rows rule)."""
    dev = logits.device
    t = torch.tensor(temps, dtype=torch.float32, device=dev).clamp_min(1e-6)
    p = torch.tensor(top_ps, dtype=torch.float32, device=dev)
    scaled = logits / t[:, None]
    sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    cutoff_idx = ((cum - probs) < p[:, None]).sum(dim=-1) - 1
    cutoff = torch.gather(sorted_logits, -1, cutoff_idx[:, None])
    return scaled.masked_fill(scaled < cutoff, float("-inf"))


def _sample_rows(logits: torch.Tensor,
                 generators: Sequence[Optional[torch.Generator]],
                 temps: Sequence[float],
                 top_ps: Sequence[float], mesh=None) -> torch.Tensor:
    """Per-row sampling of (B, V) f32 logits -> (B,) int32: rows with
    temperature <= 0 take the argmax; the others draw from their
    temperature-scaled, top-p-masked distribution with their own
    generator. temps and top_ps live on the host, so an all-greedy batch
    pays the argmax only and nothing waits for the device. Under a
    tensor-parallel mesh every rank's generator is seeded alike, and the
    first rank's draws are broadcast all the same."""
    out = logits.argmax(dim=-1).to(torch.int32)
    rows = [i for i, t in enumerate(temps) if t > 0.0]
    if rows:
        probs = torch.softmax(_top_p_masked(logits, temps, top_ps), dim=-1)
        for i in rows:
            out[i] = torch.multinomial(probs[i], 1,
                                       generator=generators[i])[0]
        if mesh is not None:
            mesh.broadcast_first(out)
    return out


def _prefill_slot(model, cache, slot: int, input_ids: torch.Tensor,
                  seq_len: int, video_features: Optional[torch.Tensor],
                  generator, temp: float, top_p: float) -> torch.Tensor:
    """Prefill one whole request (1, s_pad) into row `slot` from position
    0 and sample its first token -> (1,) int32 on the device."""
    dev = input_ids.device
    rowc = _slice_row(cache, slot)
    rowc.length = torch.zeros((1,), dtype=torch.int32, device=dev)
    s = input_ids.shape[1]
    embeds = model.build_inputs_embeds(input_ids, video_features)
    positions = torch.arange(s, dtype=torch.int32, device=dev)[None]
    hidden, rowc = model.llm.forward_hidden(
        embeds, positions, rowc,
        new_length=torch.tensor([seq_len], dtype=torch.int32, device=dev))
    logits = model.llm.logits(hidden[:, seq_len - 1])
    _insert_row(cache, rowc, slot)
    return _sample_rows(logits, [generator], [temp], [top_p],
                        tp_mesh(model))


def _prefill_chunk(model, cache, slot: int, ids_chunk: torch.Tensor,
                   base: int, seq_len: int, generator, temp: float,
                   top_p: float) -> Optional[torch.Tensor]:
    """One window [base, base + P) of a chunked prefill into row `slot`
    (the cached s > 1 path takes the offset). On the final window
    (base + P >= seq_len) sample the first token -> (1,) int32; else
    None (the JAX engine samples every window and drops the token)."""
    dev = ids_chunk.device
    p = ids_chunk.shape[1]
    rowc = _slice_row(cache, slot)
    rowc.length = torch.tensor([base], dtype=torch.int32, device=dev)
    embeds = model.build_inputs_embeds(ids_chunk, None)
    positions = base + torch.arange(p, dtype=torch.int32, device=dev)[None]
    hidden, rowc = model.llm.forward_hidden(
        embeds, positions, rowc,
        new_length=torch.tensor([min(base + p, seq_len)], dtype=torch.int32,
                                device=dev))
    _insert_row(cache, rowc, slot)
    if base + p < seq_len:
        return None
    logits = model.llm.logits(hidden[:, seq_len - 1 - base])
    return _sample_rows(logits, [generator], [temp], [top_p],
                        tp_mesh(model))


def _decode_chunk(model, cache, tokens: torch.Tensor, active: torch.Tensor,
                  temps: Sequence[float], top_ps: Sequence[float],
                  generators: Sequence[Optional[torch.Generator]],
                  chunk: int) -> torch.Tensor:
    """`chunk` decode steps over all slots -> (B, chunk) int32 tokens on
    the device. Inactive rows keep their cache length and their token;
    their outputs are ignored by the host."""
    out = []
    tok = tokens
    mesh = tp_mesh(model)
    for _ in range(chunk):
        old = cache.length
        logits, cache = model.llm.decode_step(tok, cache)
        nxt = _sample_rows(logits, generators, temps, top_ps, mesh)
        cache.length = torch.where(active, cache.length, old)
        tok = torch.where(active, nxt, tok)
        out.append(nxt)
    return torch.stack(out, dim=1)


def _set_ctx_row(ctx, ctx_len, slot: int, padded_ids: torch.Tensor,
                 seq_len: int, tok: torch.Tensor) -> None:
    """Reset context row `slot` to a freshly prefilled prompt and its
    first token (the prompt-lookup state of the speculative chunks)."""
    ctx[slot] = 0
    ctx[slot, :padded_ids.shape[1]] = padded_ids[0]
    _ctx_finish_prefill(ctx, ctx_len, slot, seq_len, tok)


def _ctx_write_chunk(ctx, slot: int, chunk: torch.Tensor, base: int) -> None:
    """Write a prefill window's ids into context row `slot` at `base`."""
    write_rows(ctx[slot:slot + 1], chunk, torch.tensor([base]))


def _ctx_finish_prefill(ctx, ctx_len, slot: int, seq_len: int,
                        tok: torch.Tensor) -> None:
    """Append the first sampled token at `seq_len` and set the row's
    context length."""
    ctx[slot, seq_len] = tok[0]
    ctx_len[slot] = seq_len + 1


def _append_ctx(ctx, ctx_len, toks: torch.Tensor,
                active: torch.Tensor) -> None:
    """Append a plain chunk's tokens to the context rows (keeps the
    prompt-lookup state fresh across plain chunks)."""
    write_rows(ctx, toks, ctx_len)
    ctx_len += torch.where(active, toks.shape[1], 0).to(ctx_len.dtype)


def _decode_chunk_pld(model, cache, ctx: torch.Tensor, ctx_len: torch.Tensor,
                      tokens: torch.Tensor, active: torch.Tensor, iters: int,
                      k: int, ngram: int):
    """`iters` greedy prompt-lookup iterations over all slots (the engine
    sends a chunk here only when every active row is greedy). Each feeds
    (last token + k drafts) per row and keeps the accepted prefix; ctx
    and ctx_len are updated in place. Returns (buf (B, iters*(k+1))
    tokens packed from 0, counts (B,), last token (B,)), all on the
    device. The cache is written k+1 past `length` each iteration and a
    row never advances past its capacity - (k+1), so the next
    iteration's write stays inside the row; admission keeps k+1 spare
    positions (ContinuousEngine.reserve)."""
    b = ctx.shape[0]
    dev = ctx.device
    row_cap = (cache.table.shape[1] * cache.block_size
               if isinstance(cache, PagedKVCache) else cache.k.shape[2])
    ar = torch.arange(k + 1, device=dev)
    buf = torch.zeros((b, iters * (k + 1)), dtype=torch.int32, device=dev)
    n = torch.zeros((b,), dtype=torch.int32, device=dev)
    tok = tokens
    for _ in range(iters):
        draft, dlen = find_draft(ctx, ctx_len, ngram, k)
        fed = torch.cat([tok[:, None], draft], dim=1)
        old = cache.length
        logits, cache = model.llm.forward(cache, input_ids=fed)
        m, z = accept_tokens(logits, draft, dlen, _GREEDY)
        headroom = (row_cap - (k + 1) - old).clamp_min(0)
        n_new = torch.minimum(torch.where(active, m + 1, 0), headroom)
        cand = torch.where(
            ar[None] < m[:, None],
            torch.gather(draft, 1, ar.clamp(max=k - 1)[None].expand(b, -1)),
            torch.where(ar[None] == m[:, None], z[:, None], 0))
        cand = torch.where(ar[None] < n_new[:, None], cand, 0).to(torch.int32)
        write_rows(buf, cand, n)
        write_rows(ctx, cand, ctx_len)
        cache.length = (old + n_new).to(torch.int32)
        last = torch.gather(cand, 1, (n_new - 1).clamp_min(0).long()[:, None])
        tok = torch.where(n_new > 0, last[:, 0], tok)
        ctx_len += n_new.to(ctx_len.dtype)
        n = (n + n_new).to(torch.int32)
    return buf, n, tok


# -- host-side engine ---------------------------------------------------------


@dataclasses.dataclass
class SlotRequest:
    input_ids: Sequence[int]
    max_new_tokens: int = 256
    temperature: float = 0.0
    top_p: float = 1.0
    eos_token_id: int = 2
    stop_token_ids: Sequence[int] = ()
    # (n_vid, mm_hidden) pooled video features (array or tensor)
    video_features: Optional[object] = None
    on_token: Optional[Callable[[List[int]], None]] = None
    # Sampled requests replay exactly from this seed (a generator per
    # slot, independent of what shares the batch); None draws a seed
    # from the engine's own generator.
    seed: Optional[int] = None
    # Higher admits first when slots are contended; FIFO within a class.
    priority: int = 0


class RequestHandle:
    def __init__(self, seq: int = 0, latched: bool = False):
        self.tokens: List[int] = []
        self.error: Optional[str] = None
        self._done = threading.Event()
        self._cancelled = False
        self.seq = seq
        # a replicated engine's cancellations wait for the next step
        self._latched = latched
        self._cancel_asked = False

    def result(self, timeout: Optional[float] = None) -> List[int]:
        if not self._done.wait(timeout):
            raise TimeoutError("generation not finished")
        if self.error is not None:
            raise RuntimeError(self.error)
        return self.tokens

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def cancel(self) -> None:
        """Stop generating for this request at the next chunk boundary
        (serving's substring-stop check). Tokens already delivered stay
        in `tokens`. On a replicated engine the cancellation is latched
        at the start of the next step (module docstring)."""
        if self._latched:
            self._cancel_asked = True
        else:
            self._cancelled = True


class _Slot:
    __slots__ = ("req", "handle", "last_token", "generated", "prompt_len",
                 "ready", "base", "padded", "hashes")

    def __init__(self, req, handle, prompt_len, padded=None):
        self.req = req
        self.handle = handle
        self.prompt_len = prompt_len  # post-truncation length in cache
        self.padded = padded  # (1, W) np prompt for chunked prefill
        self.ready = padded is None  # whole-prefill slots start ready
        self.base = 0  # chunked-prefill progress (prefix skip included)
        self.last_token = None
        self.generated = 0
        self.hashes = None  # block prefix hashes (prefix caching)


def _block_hashes(ids, block_size: int) -> List[str]:
    """Rolling prefix hash at every full block boundary: hash j covers
    tokens [0, (j+1)*block_size), so equal hashes mean equal prefix ids
    at equal positions and the block's K/V is reusable as it is (RoPE
    positions count from 0)."""
    h = hashlib.sha1()
    out = []
    for j in range(len(ids) // block_size):
        h.update(np.asarray(
            ids[j * block_size:(j + 1) * block_size], np.int32).tobytes())
        out.append(h.hexdigest())
    return out


class _PrefixRegistry:
    """Automatic prefix caching over the paged pool: maps each prompt's
    rolling block hashes to the pool blocks holding that prefix's K/V.
    Blocks stay warm (refcount 0, LRU order) after their last user
    retires and return to the allocator only under pool pressure, so a
    repeated prefix (a shared system prompt) skips its prefill."""

    def __init__(self):
        self.block_of: dict = {}  # hash -> block id
        self.hash_of: dict = {}  # block id -> hash
        self.refs: dict = {}  # block id -> refcount
        self.lru: "OrderedDict" = OrderedDict()  # refcount-0 blocks

    def lookup(self, hashes: List[str]) -> List[int]:
        """Block ids of the longest cached prefix run (a ref is taken on
        each; hand surplus back with release())."""
        out = []
        for h in hashes:
            b = self.block_of.get(h)
            if b is None:
                break
            out.append(b)
        for b in out:
            self.refs[b] += 1
            self.lru.pop(b, None)
        return out

    def add(self, h: str, block: int) -> bool:
        """Register a freshly prefilled block (refcount 1 for its
        producer row). False if another row registered this prefix
        first; the caller keeps its duplicate block private."""
        if h in self.block_of:
            return False
        self.block_of[h] = block
        self.hash_of[block] = h
        self.refs[block] = 1
        return True

    def release(self, blocks: List[int]) -> None:
        for b in blocks:
            self.refs[b] -= 1
            if self.refs[b] == 0:
                self.lru[b] = None

    def evict(self, n: int) -> List[int]:
        """Reclaim up to n cold (refcount-0) blocks for the allocator."""
        out = []
        while self.lru and len(out) < n:
            b, _ = self.lru.popitem(last=False)
            del self.block_of[self.hash_of.pop(b)]
            del self.refs[b]
            out.append(b)
        return out


class ImpossibleRequest(Exception):
    """The request needs more pool blocks than exist: waiting on the
    free list would hang it (and block everything behind it)."""


class _BlockAllocator:
    """Host-side free list over the paged pool. Block 0 is the pad block:
    table entries past a row's allocation point at it and writes past a
    row's table land in it, so it is never handed out."""

    def __init__(self, num_blocks: int):
        self.capacity = num_blocks - 1
        self.free = list(range(num_blocks - 1, 0, -1))

    def alloc(self, n: int) -> Optional[List[int]]:
        if n > len(self.free):
            return None
        return [self.free.pop() for _ in range(n)]

    def release(self, blocks: List[int]) -> None:
        self.free.extend(blocks)


class ContinuousEngine:
    """Continuous batching over `num_slots` persistent cache rows of
    `model` (a models.video_llava.VideoLLaVA), on the model's device.

    Drive with `step_once()` (deterministic; tests and single-threaded
    callers) or `start()`/`stop()` for a background scheduler thread;
    `submit()` is thread-safe either way.

    paged=True swaps the slot cache for a PagedKVCache: a pool of
    `num_blocks` blocks of `block_size` positions mapped per row by block
    tables. Admission allocates the blocks a request can touch and
    retirement frees them, so a smaller pool serves the same traffic;
    when the pool is short, admission waits. prefix_cache=True (paged
    only) shares the blocks of repeated prompt prefixes. `mesh` (or the
    model's own): tensor-parallel serving, see the module docstring."""

    def __init__(
        self,
        model,
        cfg: VideoLLaVAConfig,
        *,
        num_slots: int = 4,
        max_cache_len: int = 1024,
        cache_dtype=torch.bfloat16,
        chunk: int = 8,
        prompt_pad: int = 64,
        prefill_chunk: int = 256,
        seed: int = 0,
        mesh=None,
        speculative: bool = True,
        spec_k: int = 8,
        spec_ngram: int = 3,
        paged: bool = False,
        block_size: int = 64,
        num_blocks: Optional[int] = None,
        prefix_cache: bool = False,
    ):
        self.model = model
        self.cfg = cfg
        self.mesh = tp_mesh(model, mesh)
        # the LLM's own configuration: under a mesh, the local KV heads
        llm_cfg = model.llm.cfg
        self.device = model.llm.final_norm.scale.device
        self.num_slots = num_slots
        self.max_cache_len = max_cache_len
        self.chunk = chunk
        self.prompt_pad = prompt_pad
        # the fixed prefill window must fit the cache row
        self.prefill_chunk = min(prefill_chunk, max_cache_len)
        # Speculation runs chunks whose active rows are ALL greedy; mixed
        # or sampled chunks take the plain path, whose tokens still feed
        # the per-slot context so later speculative chunks draft well.
        self.speculative = speculative
        self.spec_k = spec_k
        self.spec_ngram = spec_ngram
        self.spec_margin = spec_k + 1 if speculative else 0
        # What admission and the exhaustion check keep free past a
        # request's prompt and generation, so every cache write stays in
        # its row: a plain chunk advances up to `chunk` positions, and a
        # speculative verify writes k+1 (its advance is clamped on the
        # device, see _decode_chunk_pld).
        self.reserve = max(spec_k + 1, chunk) if speculative else chunk
        self.paged = paged
        if paged:
            # window writes go whole blocks at a time and must stay
            # block-aligned; a verify writes k+1 tokens at any alignment
            # and must take the token-at-a-time path
            if prompt_pad % block_size:
                raise ValueError(f"prompt_pad {prompt_pad} is not a "
                                 f"multiple of block_size {block_size}")
            if speculative and (spec_k + 1) % block_size == 0:
                raise ValueError(f"spec_k + 1 = {spec_k + 1} must not be a "
                                 f"multiple of block_size {block_size}")
            # align the window down (min(256, ML) can be any value)
            self.prefill_chunk = max(
                block_size, (self.prefill_chunk // block_size) * block_size)
            self.block_size = block_size
            self.max_blocks = -(-max_cache_len // block_size)
            if num_blocks is None:
                # the slot cache's capacity, plus the pad block
                num_blocks = num_slots * self.max_blocks + 1
            self.cache = PagedKVCache.create(
                llm_cfg, num_slots, num_blocks, block_size, self.max_blocks,
                cache_dtype, self.device)
            self.alloc = _BlockAllocator(num_blocks)
            # per-slot block ownership: `shared` blocks are registry-
            # refcounted prefix blocks, `owned` return to the allocator
            self.slot_shared: List[List[int]] = [[] for _ in range(num_slots)]
            self.slot_owned: List[List[int]] = [[] for _ in range(num_slots)]
            self.prefix = _PrefixRegistry() if prefix_cache else None
        else:
            if prefix_cache:
                raise ValueError("prefix_cache requires paged=True")
            self.cache = KVCache.create(llm_cfg, num_slots, max_cache_len,
                                        cache_dtype, self.device)
        if self.mesh is not None:
            # heads local on 'model'; tables and lengths whole
            self.cache = shard_kv_cache(self.cache, model.llm)
        if speculative:
            # a prefill writes whole windows into the context row: size
            # past the worst overshoot
            cap = max_cache_len + self.spec_margin + max(chunk, prefill_chunk)
            self.ctx = torch.zeros((num_slots, cap), dtype=torch.int32,
                                   device=self.device)
            self.ctx_len = torch.zeros((num_slots,), dtype=torch.int32,
                                       device=self.device)
        self.stats = {"spec_chunks": 0, "plain_chunks": 0,
                      "spec_tokens": 0, "prefix_hit_tokens": 0}
        self.generators: List[Optional[torch.Generator]] = [None] * num_slots
        self.slots: List[Optional[_Slot]] = [None] * num_slots
        # heap of (-priority, seq, req, handle): higher priority admits
        # first, FIFO within a class
        self.pending: list = []
        self._seq = 0
        self.lock = threading.Lock()
        self.work = threading.Condition(self.lock)
        self.rng = torch.Generator().manual_seed(seed)
        self._thread = None
        self._stop = False
        self._dead = False

    # -- submission ----------------------------------------------------

    @driver.replicated
    def submit(self, req: SlotRequest) -> RequestHandle:
        handle = RequestHandle(self._seq + 1, self.mesh is not None)
        if self._dead:
            handle.error = "engine stopped after repeated step failures"
            handle._done.set()
            return handle
        with self.work:
            self._seq += 1
            heapq.heappush(self.pending,
                           (-req.priority, self._seq, req, handle))
            self.work.notify()
        return handle

    def _handles(self):
        return ([st.handle for st in self.slots if st is not None]
                + [e[3] for e in self.pending])

    def _take_cancellations(self) -> List[int]:
        """The requests whose cancellation was asked since the last
        step (latched handles only)."""
        with self.lock:
            return [h.seq for h in self._handles()
                    if h._cancel_asked and not h._cancelled]

    # -- scheduling ----------------------------------------------------

    def _generator(self, seed: Optional[int]) -> torch.Generator:
        """The slot's generator: seeded by the request, or from the
        engine's own stream."""
        if seed is None:
            seed = int(torch.randint(0, 2 ** 62, (), generator=self.rng))
        return torch.Generator(device=self.device).manual_seed(seed)

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    def _alloc_blocks(self, slot: int, ids, window: Optional[int], req,
                      hashes=None) -> Optional[int]:
        """Paged admission: reserve every block a delivered token can
        read, prompt + max_new + the verify/chunk reserve. With `hashes`
        (prefix caching) the longest registry run maps in as shared
        read-only blocks and its prefill is skipped block by block (at
        least one token always prefills: the last window samples the
        first output). Window writes past the allocation land in the pad
        block or the row's own not-yet-valid tail and are masked by the
        length, so they cost no blocks. `window` (a video's whole-span
        prefill) reserves its padded span; None for chunked prefill.
        Returns the skipped token count, or None (leave the request
        pending) when the pool cannot cover it yet."""
        bs = self.block_size
        shared: List[int] = []
        skip = 0
        if hashes and self.prefix is not None:
            run = self.prefix.lookup(hashes)
            k = min(len(run), (len(ids) - 1) // bs)
            self.prefix.release(run[k:])
            shared = run[:k]
            skip = k * bs
        need = max(window or 0,
                   len(ids) + req.max_new_tokens + 1 + self.reserve)
        n = min(-(-need // bs), self.max_blocks)
        n_fresh = n - len(shared)
        if n_fresh > self.alloc.capacity:
            if shared:
                self.prefix.release(shared)
            raise ImpossibleRequest(
                f"request needs {n_fresh} pool blocks; the pool only has "
                f"{self.alloc.capacity} (raise num_blocks or lower "
                "max_new_tokens)")
        fresh = self.alloc.alloc(n_fresh)
        if fresh is None and self.prefix is not None:
            # reclaim cold prefix blocks under pool pressure
            self.alloc.release(
                self.prefix.evict(n_fresh - len(self.alloc.free)))
            fresh = self.alloc.alloc(n_fresh)
        if fresh is None:
            if shared:
                self.prefix.release(shared)
            return None
        self.slot_shared[slot] = shared
        self.slot_owned[slot] = fresh
        row = np.zeros((self.max_blocks,), np.int32)
        row[:n] = shared + fresh
        self.cache.table[slot] = self._tensor(row)
        return skip

    def _promote(self, slot: int, st: _Slot) -> None:
        """Publish a finished prefill's full prompt blocks to the prefix
        registry, in order, stopping at the first hash another row
        published first (lookups walk the chain from block 0)."""
        shared, owned = self.slot_shared[slot], self.slot_owned[slot]
        full = min(len(st.hashes), st.prompt_len // self.block_size)
        j = len(shared)
        while j < full and owned:
            if not self.prefix.add(st.hashes[j], owned[0]):
                break
            shared.append(owned.pop(0))
            j += 1

    def _retire(self, slot: int) -> None:
        """Free a slot. Its length goes to 0, so a free row rides later
        decode chunks reading nothing; paged mode returns its owned
        blocks to the pool, drops its refs on shared prefix blocks (they
        stay warm) and points its table row at the pad block, so its
        masked writes never touch a block's next owner."""
        self.slots[slot] = None
        self.generators[slot] = None
        self.cache.length[slot] = 0
        if self.paged:
            if self.slot_shared[slot]:
                self.prefix.release(self.slot_shared[slot])
            self.alloc.release(self.slot_owned[slot])
            self.slot_shared[slot] = []
            self.slot_owned[slot] = []
            self.cache.table[slot] = 0

    def _fail(self, handle: RequestHandle, msg: str) -> None:
        handle.error = msg
        handle._done.set()

    def _admit(self) -> None:
        """Assign pending requests to free slots: text prompts enter
        chunked prefill, video prompts prefill whole at once."""
        while self.pending and None in self.slots:
            with self.lock:
                if not self.pending:
                    break
                entry = heapq.heappop(self.pending)
            _, _, req, handle = entry
            slot = self.slots.index(None)
            ids = list(req.input_ids)
            budget = self.max_cache_len - self.reserve - 1
            if len(ids) + req.max_new_tokens > budget:
                if req.video_features is not None:
                    # trimming would cut the <vid_patch> span
                    self._fail(handle, (
                        f"video prompt of {len(ids)} tokens + "
                        f"{req.max_new_tokens} new exceeds the cache budget "
                        f"{budget}; raise max_cache_len"))
                    continue
                # trim the prompt head, keeping room to generate plus the
                # within-chunk write overshoot
                ids = ids[-max(1, budget - req.max_new_tokens):]

            if req.video_features is None:
                p = self.prefill_chunk
                # every window must fit the cache row
                cap_aligned = (self.max_cache_len // p) * p
                ids = ids[-cap_aligned:]
                skip, hashes = 0, None
                if self.paged:
                    if self.prefix is not None:
                        hashes = _block_hashes(ids, self.block_size)
                    try:
                        skip = self._alloc_blocks(slot, ids, None, req,
                                                  hashes)
                    except ImpossibleRequest as e:
                        self._fail(handle, str(e))
                        continue
                    if skip is None:
                        with self.lock:
                            heapq.heappush(self.pending, entry)
                        break
                # the window grid starts at the prefix skip
                w = skip + -(-(len(ids) - skip) // p) * p
                padded = np.zeros((1, w), np.int32)
                padded[0, :len(ids)] = ids
                self.generators[slot] = self._generator(req.seed)
                st = _Slot(req, handle, len(ids), padded)
                st.base = skip
                st.hashes = hashes
                if skip:
                    self.stats["prefix_hit_tokens"] += skip
                    # Until its first window runs, the row rides decode
                    # chunks as an inactive row whose masked write lands
                    # at its length: at 0 that is a shared prefix block.
                    # Start it at the skip, in its own blocks. (The JAX
                    # engine leaves it at 0.)
                    self.cache.length[slot] = skip
                    if self.speculative:
                        # the lookup context still needs the skipped ids
                        for b0 in range(0, skip, p):
                            _ctx_write_chunk(
                                self.ctx, slot,
                                self._tensor(padded[:, b0:b0 + p]), b0)
                self.slots[slot] = st
                continue

            s_pad = -(-len(ids) // self.prompt_pad) * self.prompt_pad
            if self.paged:
                try:
                    got = self._alloc_blocks(slot, ids, s_pad, req)
                except ImpossibleRequest as e:
                    self._fail(handle, str(e))
                    continue
                if got is None:
                    with self.lock:
                        heapq.heappush(self.pending, entry)
                    break
            padded = np.zeros((1, s_pad), np.int32)
            padded[0, :len(ids)] = ids
            padded_t = self._tensor(padded)
            self.generators[slot] = self._generator(req.seed)
            tok = _prefill_slot(
                self.model, self.cache, slot, padded_t, len(ids),
                self._tensor(req.video_features)[None],
                self.generators[slot], req.temperature, req.top_p)
            if self.speculative:
                _set_ctx_row(self.ctx, self.ctx_len, slot, padded_t,
                             len(ids), tok)
            st = _Slot(req, handle, len(ids))
            st.last_token = int(tok[0])
            st.generated = 1
            self.slots[slot] = st
            if not self._deliver(st, [st.last_token]):
                self._retire(slot)  # a one-token request ends at prefill

    def _advance_prefill(self) -> bool:
        """Run ONE prefill window for the first slot still prefilling (a
        long admission never stalls decode by more than one window).
        Returns True if a window ran."""
        for i, st in enumerate(self.slots):
            if st is None or st.ready:
                continue
            if st.handle._cancelled:
                st.handle._done.set()
                self._retire(i)
                continue
            p = self.prefill_chunk
            chunk = self._tensor(st.padded[:, st.base:st.base + p])
            tok = _prefill_chunk(
                self.model, self.cache, i, chunk, st.base, st.prompt_len,
                self.generators[i], st.req.temperature, st.req.top_p)
            if self.speculative:
                _ctx_write_chunk(self.ctx, i, chunk, st.base)
            st.base += p
            if tok is not None:
                if self.speculative:
                    _ctx_finish_prefill(self.ctx, self.ctx_len, i,
                                        st.prompt_len, tok)
                st.ready = True
                st.last_token = int(tok[0])
                st.generated = 1
                if self.paged and self.prefix is not None and st.hashes:
                    self._promote(i, st)
                if not self._deliver(st, [st.last_token]):
                    self._retire(i)
            return True
        return False

    def _deliver(self, st: _Slot, new_tokens: List[int]) -> bool:
        """Append tokens to the request, honouring its stop conditions.
        Returns False when the request finished."""
        req = st.req
        if st.handle._cancelled:
            st.handle._done.set()
            return False
        stops = {req.eos_token_id, *req.stop_token_ids}
        emit: List[int] = []
        alive = True
        for t in new_tokens:
            if t in stops:
                alive = False
                break
            emit.append(t)
            if len(st.handle.tokens) + len(emit) >= req.max_new_tokens:
                alive = False
                break
        if emit:
            st.handle.tokens.extend(emit)
            if req.on_token is not None:
                try:
                    req.on_token(emit)
                except Exception:  # noqa: BLE001
                    # a broken streaming callback (a client that hung up)
                    # cancels its own request, never the scheduler; a
                    # replicated engine latches it for the next step
                    logging.getLogger(__name__).exception(
                        "on_token callback failed; cancelling its request")
                    if st.handle._latched:
                        st.handle.cancel()
                    else:
                        alive = False
        if (st.prompt_len + len(st.handle.tokens) + 1 + self.reserve
                > self.max_cache_len):
            alive = False  # another chunk could run past the row's end
        if not alive:
            st.handle._done.set()
        return alive

    def step_once(self) -> bool:
        """One scheduler iteration: admit pending requests, run one
        prefill window and one decode chunk, deliver tokens. Returns True
        if any work was done."""
        if self.mesh is None:
            return self._step(())
        return self._step(self._take_cancellations())

    @driver.replicated
    @torch.inference_mode()
    def _step(self, cancelled) -> bool:
        if cancelled:
            wanted = set(cancelled)
            with self.lock:
                for h in self._handles():
                    if h.seq in wanted:
                        h._cancelled = True
        self._admit()
        prefilled = self._advance_prefill()
        live = [i for i, s in enumerate(self.slots)
                if s is not None and s.ready]
        if not live:
            return prefilled
        b = self.num_slots
        active = np.zeros((b,), bool)
        tokens = np.zeros((b,), np.int32)
        temps, top_ps = [0.0] * b, [1.0] * b
        for i in live:
            st = self.slots[i]
            active[i] = True
            tokens[i] = st.last_token
            temps[i] = st.req.temperature
            top_ps[i] = st.req.top_p
        active_t, tokens_t = self._tensor(active), self._tensor(tokens)

        if self.speculative and all(temps[i] <= 0.0 for i in live):
            buf, counts, last = _decode_chunk_pld(
                self.model, self.cache, self.ctx, self.ctx_len, tokens_t,
                active_t, self.chunk, self.spec_k, self.spec_ngram)
            # one device-to-host copy per chunk
            out = torch.cat([buf, counts[:, None], last[:, None]], 1).cpu()
            out = out.numpy()
            buf, counts, last = out[:, :-2], out[:, -2], out[:, -1]
            self.stats["spec_chunks"] += 1
            self.stats["spec_tokens"] += int(counts[active].sum())
            for i in live:
                st = self.slots[i]
                if self._deliver(st, buf[i, :counts[i]].tolist()):
                    st.last_token = int(last[i])
                    st.generated += int(counts[i])
                else:
                    self._retire(i)
            return True

        toks_t = _decode_chunk(self.model, self.cache, tokens_t, active_t,
                               temps, top_ps, self.generators, self.chunk)
        if self.speculative:
            # keep the prompt-lookup context fresh for later spec chunks
            _append_ctx(self.ctx, self.ctx_len, toks_t, active_t)
        toks = toks_t.cpu().numpy()  # one device-to-host copy per chunk
        self.stats["plain_chunks"] += 1
        for i in live:
            st = self.slots[i]
            if self._deliver(st, toks[i].tolist()):
                st.last_token = int(toks[i, -1])
                st.generated += self.chunk
            else:
                self._retire(i)
        return True

    # -- background thread --------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError("the scheduler thread is already running")
        self._stop = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        with self.work:
            self._stop = True
            self.work.notify()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    @driver.replicated
    def _fail_all(self, msg: str) -> None:
        """Fail every in-flight and pending request (the scheduler's
        backstop: a hung handle is worse than an errored one)."""
        for i, st in enumerate(self.slots):
            if st is not None:
                self._fail(st.handle, msg)
                self._retire(i)
        with self.lock:
            while self.pending:
                *_, handle = heapq.heappop(self.pending)
                self._fail(handle, msg)

    @torch.inference_mode()
    def _run(self) -> None:
        errors = 0
        while True:
            try:
                did = self.step_once()
                errors = 0
            except Exception as e:  # noqa: BLE001 (never die silently)
                errors += 1
                logging.getLogger(__name__).exception(
                    "continuous engine step failed (%d consecutive)", errors)
                self._fail_all(f"engine step failed: {e!r}")
                if errors >= 3:
                    # a persistent failure (bad weights, device gone):
                    # stop rather than spin; submit() fails fast
                    self._dead = True
                    self._stop = True
                    return
                did = True
            if not did:
                with self.work:
                    if self._stop:
                        return
                    if not self.pending and not any(self.slots):
                        self.work.wait(timeout=0.1)
            with self.lock:
                if self._stop and not any(self.slots) and not self.pending:
                    return
