"""OpenAI-compatible chat-completions server over the port's Vicuna.

Counterpart of video_llava_tpu/serving/server.py: the endpoint that
stands in for the reference's FastChat-served judge
(quantitative_evaluation/README.md:5-16), and video chat: a user
message whose content is an OpenAI vision-style part list with a
`video_url` part (a `data:video/...;base64,` body or a local path) runs
decode, CLIP encode, pooling and projection and answers about the clip.

Four modes: the default serialized one (one request at a time behind a
lock, speculative decoding for non-streamed requests), the windowed
batcher (BatchingChatModel: text requests that arrive within a window
decode as one right-padded batch), and continuous batching over the
slot cache or the paged pool (ContinuousChatModel, engine/continuous.py).

Tensor parallel (``--mesh_model``): the HTTP server, the batching window
and the stop strings run on rank 0; the ChatModel and the continuous
engine are built on every rank (parallel/driver.new) and their
computing methods (encode_frames, respond, generate_batch; the engine's
submit and steps) are replicated, so the other ranks run each forward
with rank 0. Video is decoded on rank 0 and its frames travel with the
call.
"""

from __future__ import annotations

import base64
import contextlib
import dataclasses
import json
import math
import os
import queue
import tempfile
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Tuple

import numpy as np
import torch

from video_llava_tpu_torch.config import GenerationConfig, VideoLLaVAConfig
from video_llava_tpu_torch.engine.generate import (
    GenerateResult,
    generate,
    generate_with_keywords,
    tp_mesh,
)
from video_llava_tpu_torch.engine.speculative import (
    generate_pld,
    generate_pld_text,
)
from video_llava_tpu_torch.ops.image import preprocess_frames
from video_llava_tpu_torch.parallel import driver
from video_llava_tpu_torch.runtime.conversation import conv_templates
from video_llava_tpu_torch.runtime.inference import build_video_question
from video_llava_tpu_torch.runtime.tokenizer import Tokenizer

def _split_content(content) -> Tuple[str, List[str]]:
    """OpenAI message content -> (text, video urls). Takes the plain
    string and the vision-style part list ({"type": "text"} /
    {"type": "video_url"}); other part types raise rather than drop
    media the caller sent."""
    if isinstance(content, str):
        return content, []
    texts, media = [], []
    for part in content:
        ptype = part.get("type")
        if ptype == "text":
            texts.append(part.get("text", ""))
        elif ptype == "video_url":
            url = part.get("video_url")
            if isinstance(url, dict):
                url = url.get("url")
            if not url:
                raise ValueError("video_url part missing url")
            media.append(url)
        else:
            raise ValueError(f"unsupported content part type: {ptype!r}")
    return "\n".join(t for t in texts if t), media


def _load_video_frames(url: str, image_size: int) -> np.ndarray:
    """A video_url -> sampled frames (t, h, w, 3) uint8 through the
    native decoder and the reference's uniform sampling
    (media/loader.py)."""
    from video_llava_tpu_torch.media.loader import load_video

    if url.startswith("data:"):
        header, _, body = url.partition(",")
        if ";base64" not in header:
            raise ValueError("data: video_url must be base64-encoded")
        suffix = ".mp4"
        if "/" in header:
            fmt = header.split("/", 1)[1].split(";", 1)[0]
            if fmt.isalnum():
                suffix = "." + fmt
        fd, path = tempfile.mkstemp(suffix=suffix)
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(base64.b64decode(body))
            return load_video(path, shape=(image_size, image_size))
        finally:
            os.unlink(path)
    if url.startswith("file://"):
        url = url[len("file://"):]
    return load_video(url, shape=(image_size, image_size))


@dataclasses.dataclass
class ChatModel:
    """Chat wrapper for serving: a models.video_llava.VideoLLaVA on its
    device, the tokenizer and the conversation template."""

    model: torch.nn.Module
    cfg: VideoLLaVAConfig
    tokenizer: Tokenizer
    conv_mode: str = "vicuna_v1_1"
    cache_dtype: torch.dtype = torch.bfloat16
    seq_pad_multiple: int = 128
    # Prompt-lookup speculative decoding for non-streamed requests with
    # token-id stops (engine/speculative.py), on by default as in the
    # JAX package.
    speculative: bool = True
    # the tensor-parallel mesh (the model's own when None); speculation
    # is ignored under one, as in the JAX package
    mesh: object = None

    @property
    def device(self) -> torch.device:
        return self.model.llm.final_norm.scale.device

    @property
    def tp(self):
        return tp_mesh(self.model, self.mesh)

    def build_prompt(self, messages: List[dict]):
        """messages -> (prompt token ids, stop string, video urls). The
        one video_url message of a conversation gets the reference's
        <vid_start><vid_patch>*N<vid_end> block after its text
        (runtime.inference.build_video_question)."""
        conv = conv_templates[self.conv_mode].copy()
        media: List[str] = []
        for m in messages:
            if m["role"] == "system":
                text, extra = _split_content(m["content"])
                if extra:
                    raise ValueError("system messages cannot carry video")
                conv.system = text
        for m in messages:
            if m["role"] == "user":
                text, urls = _split_content(m["content"])
                if urls:
                    if media or len(urls) > 1:
                        raise ValueError("at most one video per conversation")
                    media.extend(urls)
                    text = build_video_question(
                        text, self.cfg.video_token_len,
                        self.cfg.use_vid_start_end)
                conv.append_message(conv.roles[0], text)
            elif m["role"] == "assistant":
                text, urls = _split_content(m["content"])
                if urls:
                    raise ValueError("assistant messages cannot carry video")
                conv.append_message(conv.roles[1], text)
        conv.append_message(conv.roles[1], None)
        return (self.tokenizer.encode(conv.get_prompt()), conv.stop_string(),
                media)

    def encode_video_url(self, url: str) -> torch.Tensor:
        """video_url -> (1, video_token_len, c) features to splice."""
        return self.encode_frames(
            _load_video_frames(url, self.cfg.vision.image_size))

    @driver.replicated
    @torch.inference_mode()
    def encode_frames(self, frames: np.ndarray) -> torch.Tensor:
        """(t, h, w, 3) uint8 frames -> (1, video_token_len, c): through
        preprocessing, CLIP and pooling on the device."""
        x = torch.from_numpy(np.ascontiguousarray(frames)).to(self.device)
        pixels = preprocess_frames(x, self.cfg.vision.image_size)
        return self.model.encode_video(pixels, frames.shape[0])[None]

    def chat(self, messages: List[dict], temperature: float = 0.2,
             max_tokens: int = 512, seed: Optional[int] = None,
             on_delta=None) -> str:
        ids, stop_str, media = self.build_prompt(messages)
        frames = (_load_video_frames(media[0], self.cfg.vision.image_size)
                  if media else None)
        return self.respond(ids, stop_str, frames, temperature, max_tokens,
                            seed, on_delta)

    @driver.replicated
    @torch.inference_mode()
    def respond(self, ids: List[int], stop_str: Optional[str],
                frames: Optional[np.ndarray], temperature: float = 0.2,
                max_tokens: int = 512, seed: Optional[int] = None,
                on_delta=None) -> str:
        """The answer to a built prompt (token ids, its stop string and
        the decoded frames of its video, if any)."""
        feats = self.encode_frames(frames) if frames is not None else None
        tok = self.tokenizer
        s_real = len(ids)
        s_pad = s_real + (-s_real % self.seq_pad_multiple)
        input_ids = torch.full((1, s_pad), tok.pad_token_id,
                               dtype=torch.int64)
        input_ids[0, :s_real] = torch.tensor(ids)
        input_ids = input_ids.to(self.device)
        gen = GenerationConfig(max_new_tokens=max_tokens,
                               temperature=temperature,
                               do_sample=temperature > 0,
                               eos_token_id=tok.eos_token_id,
                               pad_token_id=tok.pad_token_id)
        generator = torch.Generator(device=self.device).manual_seed(
            seed if seed is not None else 0)
        keywords = (stop_str,) if stop_str and stop_str != "</s>" else ()
        if (self.speculative and not keywords and on_delta is None
                and self.tp is None):
            return generate_pld_text(self.model, gen, input_ids, s_real,
                                     feats, generator, tok, stop_str,
                                     cache_dtype=self.cache_dtype)

        def _post(t: str) -> str:
            # applied before the last streamed delta, so the stream
            # concatenates to the JSON result
            if stop_str and t.endswith(stop_str):
                t = t[: -len(stop_str)]
            return t.strip()

        text, _ = generate_with_keywords(
            self.model, gen, input_ids,
            torch.tensor([s_real], dtype=torch.int32, device=self.device),
            feats, generator,
            decode_fn=lambda t: tok.decode(t, skip_special_tokens=True),
            keywords=keywords, cache_dtype=self.cache_dtype,
            on_delta=on_delta, postprocess=_post,
            speculative=self.speculative)
        return text

    @driver.replicated
    @torch.inference_mode()
    def generate_batch(self, input_ids: torch.Tensor, lens: torch.Tensor,
                       gen: GenerationConfig, seed: int) -> GenerateResult:
        """A right-padded text batch through engine.generate.generate
        (speculative.generate_pld when the model speculates, off a
        mesh), sampling from a generator seeded with `seed`."""
        generator = torch.Generator(device=self.device).manual_seed(seed)
        gen_fn = (generate_pld if self.speculative and self.tp is None
                  else generate)
        return gen_fn(self.model, gen, input_ids.to(self.device),
                      lens.to(self.device), None, generator,
                      cache_dtype=self.cache_dtype)


class ContinuousChatModel:
    """Continuous-batching server model (engine/continuous.py): every
    request, streamed or not, greedy or sampled, shares one persistent
    batch of slots, admitted and retired at chunk boundaries. Substring
    stops (templates other than '</s>') are checked on the host over the
    streamed chunks and cancel the slot. A seeded request replays
    exactly: each slot samples from its own generator."""

    def __init__(self, model: ChatModel, num_slots: int = 4,
                 max_cache_len: int = 2048, chunk: int = 8,
                 paged: bool = False, block_size: int = 64,
                 num_blocks: Optional[int] = None,
                 prefix_cache: bool = False):
        from video_llava_tpu_torch.engine.continuous import ContinuousEngine

        self.model = model
        paged = paged or prefix_cache
        # paged blocks must divide the prompt pad (window writes are
        # whole blocks): shrink to their gcd when the model pads finer,
        # rescaling num_blocks so the pool keeps the capacity the caller
        # sized in the requested block units
        requested_bs = block_size
        block_size = math.gcd(block_size, model.seq_pad_multiple)
        if num_blocks is not None:
            num_blocks *= requested_bs // block_size
        self._mm_lock = threading.Lock()
        self.engine = driver.new(
            ContinuousEngine, model.model, model.cfg, num_slots=num_slots,
            max_cache_len=max_cache_len, cache_dtype=model.cache_dtype,
            chunk=chunk, prompt_pad=model.seq_pad_multiple,
            speculative=model.speculative, paged=paged,
            block_size=block_size, num_blocks=num_blocks,
            prefix_cache=prefix_cache, mesh=model.mesh)
        self.engine.start()

    def close(self):
        self.engine.stop()

    def chat(self, messages: List[dict], temperature: float = 0.2,
             max_tokens: int = 512, seed: Optional[int] = None,
             on_delta=None) -> str:
        from video_llava_tpu_torch.engine.continuous import SlotRequest

        tok = self.model.tokenizer
        ids, stop_str, media = self.model.build_prompt(messages)
        feats = None
        if media:
            # video rides the slot engine: encode under the lock (one
            # media decode at a time), then submit with the features
            with self._mm_lock:
                feats = self.model.encode_video_url(media[0])[0]
        keyword = stop_str if stop_str and stop_str != "</s>" else None
        state = {"handle": None, "sent": 0}
        ready = threading.Event()  # the handle is set before any token

        def _visible(raw: str) -> str:
            if keyword and keyword in raw:
                raw = raw[: raw.index(keyword)]
            if stop_str and raw.endswith(stop_str):
                raw = raw[: -len(stop_str)]
            return raw.strip()

        def on_token(_chunk):
            # the engine thread can deliver the first chunk before
            # submit() returns on this thread
            ready.wait()
            h = state["handle"]
            raw = tok.decode(h.tokens, skip_special_tokens=True)
            if keyword and keyword in raw:
                h.cancel()
            text = _visible(raw)
            # hold back the tail that could still become a stop keyword,
            # so nothing streamed ever needs retracting
            if keyword and keyword not in raw:
                text = text[: max(0, len(text) - (len(keyword) - 1))]
            if on_delta is not None and len(text) > state["sent"]:
                on_delta(text[state["sent"]:])
                state["sent"] = len(text)

        handle = self.engine.submit(SlotRequest(
            ids, max_new_tokens=max_tokens,
            temperature=temperature if temperature > 0 else 0.0,
            eos_token_id=tok.eos_token_id, video_features=feats,
            on_token=on_token, seed=seed))
        state["handle"] = handle
        ready.set()
        text = _visible(tok.decode(handle.result(), skip_special_tokens=True))
        if on_delta is not None and len(text) > state["sent"]:
            on_delta(text[state["sent"]:])
        return text


class BatchingChatModel:
    """Windowed request batching (JAX serving/server.py:566-746): text
    requests that arrive within `window_ms` of the first, up to
    `max_batch`, run as ONE right-padded prefill and decode through
    engine.generate.generate (speculative.generate_pld when the model
    speculates), on one worker thread. Stops are token ids (eos), the
    '</s>' of the vicuna templates. A batch samples at its first
    request's temperature, seeded by its first non-None seed (else 0);
    each row keeps min(its length, its max_tokens) tokens. Video
    requests, and streams (the handler's), run alone on the worker
    (run_exclusive), so one program uses the device at a time.

    Text requests' max_tokens are capped at max_tokens_cap; video
    requests pass uncapped, as in the JAX package (a fault of it, kept
    here for parity)."""

    _EXCLUSIVE = object()
    _STOP = object()

    def __init__(self, model: ChatModel, max_batch: int = 8,
                 window_ms: float = 30.0, max_tokens_cap: int = 512):
        self.model = model
        self.max_batch = max_batch
        self.window_s = window_ms / 1000.0
        self.max_tokens_cap = max_tokens_cap
        self.batch_sizes: List[int] = []  # the batches the worker formed
        self._queue: "queue.Queue" = queue.Queue()
        self._pending = None
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def close(self):
        """Stop the worker (idempotent). A batch in flight finishes;
        requests queued after the stop are not served."""
        self._queue.put((self._STOP,))
        self._worker.join(timeout=10)

    def chat(self, messages: List[dict], temperature: float = 0.2,
             max_tokens: int = 512, seed: Optional[int] = None) -> str:
        if any(_split_content(m.get("content", ""))[1] for m in messages):
            # the feature splice does not ride the batched token path
            return self.run_exclusive(lambda: self.model.chat(
                messages, temperature=temperature, max_tokens=max_tokens,
                seed=seed))
        done = threading.Event()
        slot: dict = {}
        self._queue.put((messages, temperature,
                         min(max_tokens, self.max_tokens_cap), seed, slot,
                         done))
        done.wait()
        if "error" in slot:
            raise RuntimeError(slot["error"])
        return slot["text"]

    def run_exclusive(self, fn):
        """Run fn() on the worker thread, between batches."""
        done = threading.Event()
        slot: dict = {}
        self._queue.put((self._EXCLUSIVE, fn, slot, done))
        done.wait()
        if "error" in slot:
            raise RuntimeError(slot["error"])
        return slot.get("result")

    # -- worker ---------------------------------------------------------------

    def _collect(self) -> list:
        first = (self._pending if self._pending is not None
                 else self._queue.get())
        self._pending = None
        batch = [first]
        if first[0] is self._EXCLUSIVE or first[0] is self._STOP:
            return batch
        deadline = time.time() + self.window_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.time()
            if remaining <= 0:
                break
            try:
                item = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if item[0] is self._EXCLUSIVE or item[0] is self._STOP:
                # runs alone, next round (a stop lets this batch finish)
                self._pending = item
                break
            batch.append(item)
        return batch

    def _prompt(self, messages: List[dict]) -> str:
        m = self.model
        conv = conv_templates[m.conv_mode].copy()
        system = [_split_content(x["content"])[0]
                  for x in messages if x["role"] == "system"]
        if system:
            conv.system = system[0]
        for x in messages:
            # part-list text content flattens here (video never does)
            text = _split_content(x["content"])[0]
            if x["role"] == "user":
                conv.append_message(conv.roles[0], text)
            elif x["role"] == "assistant":
                conv.append_message(conv.roles[1], text)
        conv.append_message(conv.roles[1], None)
        return conv.get_prompt()

    @torch.inference_mode()
    def _generate(self, batch: list) -> List[str]:
        m = self.model
        tok = m.tokenizer
        ids_list = [tok.encode(self._prompt(x[0])) for x in batch]
        lens = [len(i) for i in ids_list]
        bucket = -(-max(lens) // m.seq_pad_multiple) * m.seq_pad_multiple
        input_ids = torch.full((len(batch), bucket), tok.pad_token_id,
                               dtype=torch.int64)
        for r, ids in enumerate(ids_list):
            input_ids[r, :len(ids)] = torch.tensor(ids)
        temperature = batch[0][1]
        gen = GenerationConfig(max_new_tokens=max(x[2] for x in batch),
                               temperature=temperature,
                               do_sample=temperature > 0,
                               eos_token_id=tok.eos_token_id,
                               pad_token_id=tok.pad_token_id)
        seed = next((x[3] for x in batch if x[3] is not None), 0)
        res = m.generate_batch(input_ids,
                               torch.tensor(lens, dtype=torch.int32),
                               gen, int(seed))
        toks, out_lens = res.tokens.cpu(), res.lengths.cpu()
        return [tok.decode(toks[r, :min(int(out_lens[r]), x[2])].tolist(),
                           skip_special_tokens=True).strip()
                for r, x in enumerate(batch)]

    def _run(self):
        while True:
            batch = self._collect()
            if batch[0][0] is self._STOP:
                return
            if batch[0][0] is self._EXCLUSIVE:
                _, fn, slot, done = batch[0]
                try:
                    slot["result"] = fn()
                except Exception as e:  # noqa: BLE001 (to the caller)
                    slot["error"] = str(e)
                done.set()
                continue
            self.batch_sizes.append(len(batch))
            try:
                texts = self._generate(batch)
                for text, (*_, slot, done) in zip(texts, batch):
                    slot["text"] = text
                    done.set()
            except Exception as e:  # noqa: BLE001 (to every caller)
                for *_, slot, done in batch:
                    slot["error"] = str(e)
                    done.set()


def make_handler(model, model_name: str):
    lock = threading.Lock()
    # the batcher and the continuous engine order requests themselves
    serialized = not isinstance(model, (BatchingChatModel,
                                        ContinuousChatModel))

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def _json(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = self.path.rstrip("/")
            if path.endswith("/models"):
                self._json(200, {"object": "list", "data": [
                    {"id": model_name, "object": "model"}]})
            elif path.endswith("/healthz"):
                self._json(200, {"status": "ok"})
            elif path.endswith("/metrics"):
                stats = {}
                if isinstance(model, ContinuousChatModel):
                    eng = model.engine
                    stats = {**eng.stats, "slots_total": eng.num_slots,
                             "slots_busy": sum(s is not None
                                               for s in eng.slots),
                             "pending": len(eng.pending)}
                    if eng.paged:
                        stats["blocks_free"] = len(eng.alloc.free)
                        if eng.prefix is not None:
                            stats["prefix_blocks_cached"] = len(
                                eng.prefix.refs)
                self._json(200, {"object": "metrics", **stats})
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            if not self.path.rstrip("/").endswith("/chat/completions"):
                self._json(404, {"error": "not found"})
                return
            length = int(self.headers.get("Content-Length", 0))
            try:
                req = json.loads(self.rfile.read(length))
                ctx = lock if serialized else contextlib.nullcontext()
                if req.get("stream"):
                    with ctx:
                        self._stream_chat(req)
                    return
                with ctx:
                    text = model.chat(
                        req["messages"],
                        temperature=float(req.get("temperature", 0.2)),
                        max_tokens=int(req.get("max_tokens", 512)),
                        seed=req.get("seed"))
                self._json(200, {
                    "id": f"chatcmpl-{uuid.uuid4().hex[:12]}",
                    "object": "chat.completion",
                    "created": int(time.time()),
                    "model": req.get("model", model_name),
                    "choices": [{
                        "index": 0,
                        "message": {"role": "assistant", "content": text},
                        "finish_reason": "stop"}],
                    "usage": {}})
            except Exception as e:  # noqa: BLE001 (answer, keep serving)
                self._json(500, {"error": str(e)})

        def _stream_chat(self, req: dict):
            """OpenAI-style SSE ('stream': true): one chat.completion.chunk
            per decoded chunk, then a finish_reason chunk and
            'data: [DONE]'."""
            rid = f"chatcmpl-{uuid.uuid4().hex[:12]}"
            created = int(time.time())
            name = req.get("model", model_name)
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()

            def send_chunk(delta: dict, finish=None):
                payload = {"id": rid, "object": "chat.completion.chunk",
                           "created": created, "model": name,
                           "choices": [{"index": 0, "delta": delta,
                                        "finish_reason": finish}]}
                self.wfile.write(f"data: {json.dumps(payload)}\n\n".encode())
                self.wfile.flush()

            send_chunk({"role": "assistant"})
            try:
                batching = isinstance(model, BatchingChatModel)
                base = model.model if batching else model
                run = lambda: base.chat(  # noqa: E731
                    req["messages"],
                    temperature=float(req.get("temperature", 0.2)),
                    max_tokens=int(req.get("max_tokens", 512)),
                    seed=req.get("seed"),
                    on_delta=lambda piece: send_chunk({"content": piece}))
                if batching:
                    # a stream bypasses the batched decode, but runs on
                    # the worker, between batches
                    model.run_exclusive(run)
                else:
                    run()
                send_chunk({}, finish="stop")
            except Exception as e:  # noqa: BLE001
                # headers and chunks are already on the wire: end the
                # stream with an SSE error payload, not a 500
                try:
                    self.wfile.write(
                        f"data: {json.dumps({'error': {'message': str(e)}})}"
                        "\n\n".encode())
                except OSError:
                    return
            self.wfile.write(b"data: [DONE]\n\n")
            self.wfile.flush()

    return Handler


def serve(model: ChatModel, host: str = "0.0.0.0", port: int = 8000,
          model_name: str = "vicuna-13b-v1.5", block: bool = True,
          batching: bool = False, max_batch: int = 8,
          window_ms: float = 30.0, continuous: bool = False,
          num_slots: int = 4, max_cache_len: int = 2048, paged: bool = False,
          num_blocks: Optional[int] = None,
          prefix_cache: bool = False) -> ThreadingHTTPServer:
    """Start the HTTP server (serve_forever on this thread with block,
    else on a daemon thread). The chat model it serves (a
    ContinuousChatModel in continuous mode, else a BatchingChatModel
    with batching) is `server.chat_model`; shutdown() also stops the
    continuous engine's or the batcher's thread."""
    if continuous:
        model = ContinuousChatModel(
            model, num_slots=num_slots, max_cache_len=max_cache_len,
            paged=paged or prefix_cache, num_blocks=num_blocks,
            prefix_cache=prefix_cache)
    elif batching:
        model = BatchingChatModel(model, max_batch, window_ms)
    server = ThreadingHTTPServer((host, port), make_handler(model, model_name))
    server.chat_model = model
    if continuous or batching:
        stop_server = server.shutdown

        def _shutdown():
            stop_server()
            model.close()

        server.shutdown = _shutdown
    if block:
        # the bound port (port 0 asks the system for a free one)
        print(f"serving {model_name} on {host}:{server.server_address[1]}",
              flush=True)
        try:
            server.serve_forever()
        finally:
            # an interrupted server stops its engine or batcher thread
            # too (before a tensor-parallel run sends its ranks home)
            if continuous or batching:
                model.close()
            server.server_close()
    else:
        threading.Thread(target=server.serve_forever, daemon=True).start()
    return server
