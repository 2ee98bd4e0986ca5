"""Port parity: the windowed batcher (serve(batching=True),
BatchingChatModel) against the JAX package's, over HTTP."""

import concurrent.futures
import json
import urllib.request

import jax.numpy as jnp
import numpy as np
import torch

import video_llava_tpu.serving.server as jax_server
import video_llava_tpu_torch.serving.server as server_mod
from test_torch_continuous import tiny
from video_llava_tpu_torch.serving.server import BatchingChatModel, ChatModel


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=120)


def _stream(url, body):
    pieces, finished = [], False
    with _post(url, {**body, "stream": True}) as resp:
        for line in resp:
            line = line.strip()
            if not line.startswith(b"data: "):
                continue
            payload = line[len(b"data: "):]
            if payload == b"[DONE]":
                finished = True
                break
            pieces.append(json.loads(payload)["choices"][0]["delta"].get(
                "content", ""))
    assert finished
    return "".join(pieces)


def test_batching_server_matches_jax(monkeypatch):
    """The tiny f32 model (2 layers, width 64), its JAX parameters carried
    across, greedy, no speculation, served by each package's batcher at
    max_batch 1 (one request a batch: argmax ties under other batch
    shapes may part the packages' texts): four text requests sent at
    once give the JAX batcher's texts, exactly; a video request (seeded
    frames stand in for the decode) and a stream run alone on the worker
    through run_exclusive and give the JAX serialized model's texts; the
    worker formed only batches of one; shutdown() stops it."""
    torch.set_num_threads(1)
    cfg, tok, params, model = tiny()
    frames = np.random.default_rng(3).integers(0, 256, (5, 48, 64, 3),
                                               dtype=np.uint8)
    for mod in (server_mod, jax_server):
        monkeypatch.setattr(mod, "_load_video_frames",
                            lambda url, size: frames)
    jax_chat = jax_server.ChatModel(params=params, cfg=cfg, tokenizer=tok,
                                    cache_dtype=jnp.float32,
                                    seq_pad_multiple=16, speculative=False)
    jax_batcher = jax_server.BatchingChatModel(jax_chat, max_batch=1)
    chat = ChatModel(model=model, cfg=cfg, tokenizer=tok,
                     cache_dtype=torch.float32, seq_pad_multiple=16,
                     speculative=False)
    questions = ["What happens first?", "Describe the scene in detail.",
                 "Who is there?", "Why?"]
    bodies = [{"model": "m", "temperature": 0.0, "max_tokens": 8 + 2 * i,
               "messages": [{"role": "user", "content": q}]}
              for i, q in enumerate(questions)]
    video = {"model": "m", "temperature": 0.0, "max_tokens": 6,
             "messages": [{"role": "user", "content": [
                 {"type": "text", "text": "Why?"},
                 {"type": "video_url", "video_url": {"url": "seeded"}}]}]}
    try:
        want = [jax_batcher.chat(b["messages"], temperature=0.0,
                                 max_tokens=b["max_tokens"]) for b in bodies]
    finally:
        jax_batcher.close()
    want_video = jax_chat.chat(video["messages"], temperature=0.0,
                               max_tokens=6)
    want_stream = jax_chat.chat(bodies[1]["messages"], temperature=0.0,
                                max_tokens=bodies[1]["max_tokens"])
    assert all(want) and want_video and len(set(want)) > 1

    server = server_mod.serve(chat, host="127.0.0.1", port=0, block=False,
                              model_name="m", batching=True, max_batch=1,
                              window_ms=30.0)
    batcher = server.chat_model
    assert isinstance(batcher, BatchingChatModel)
    assert (batcher.max_batch, batcher.window_s) == (1, 0.03)
    url = f"http://127.0.0.1:{server.server_address[1]}/v1/chat/completions"
    try:
        with concurrent.futures.ThreadPoolExecutor(6) as pool:
            texts = pool.map(
                lambda b: json.loads(_post(url, b).read())[
                    "choices"][0]["message"]["content"], bodies)
            streamed = pool.submit(_stream, url, bodies[1])
            got_video = pool.submit(
                lambda: json.loads(_post(url, video).read())[
                    "choices"][0]["message"]["content"])
            assert list(texts) == want
            assert streamed.result() == want_stream
            assert got_video.result() == want_video
        assert batcher.batch_sizes == [1] * len(bodies)
    finally:
        server.shutdown()
        server.server_close()
    assert not batcher._worker.is_alive()
