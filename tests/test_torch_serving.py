"""Port parity: the chat-completions server over HTTP."""

import json
import urllib.request

import jax.numpy as jnp
import torch

from test_torch_continuous import tiny
from video_llava_tpu.serving.server import ChatModel as JaxChatModel
from video_llava_tpu_torch.serving.server import ChatModel, serve


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=120)


def _get(url):
    return json.loads(urllib.request.urlopen(url, timeout=30).read())


def test_server_json_and_sse_agree_with_jax():
    """The tiny f32 model served on 127.0.0.1, port 0, twice: the default
    serialized mode (speculative decoding) and continuous batching over
    the paged pool with prefix caching. In each, a greedy JSON request
    and the same request streamed (SSE, deltas concatenated) give the
    JAX package's serialized ChatModel answer (plain greedy, the same
    parameters); a second request sharing the system prompt hits the
    prefix cache; /healthz, /models and /metrics answer."""
    cfg, tok, params, model = tiny()
    want_model = JaxChatModel(params=params, cfg=cfg, tokenizer=tok,
                              cache_dtype=jnp.float32, seq_pad_multiple=16,
                              speculative=False)
    msgs = lambda q: [  # noqa: E731
        {"role": "system", "content": "You are a helpful assistant "
         "answering questions about videos carefully."},
        {"role": "user", "content": q}]
    body = {"model": "m", "messages": msgs("What happens first?"),
            "temperature": 0.0, "max_tokens": 8}
    want = want_model.chat(body["messages"], temperature=0.0, max_tokens=8)
    chat = ChatModel(model=model, cfg=cfg, tokenizer=tok,
                     cache_dtype=torch.float32, seq_pad_multiple=16)
    for mode in ({}, {"continuous": True, "num_slots": 2,
                      "max_cache_len": 512, "prefix_cache": True}):
        server = serve(chat, host="127.0.0.1", port=0, block=False,
                       model_name="m", **mode)
        try:
            base = f"http://127.0.0.1:{server.server_address[1]}/v1"
            got = json.loads(_post(base + "/chat/completions", body).read())
            assert got["choices"][0]["message"]["content"] == want
            pieces, finished = [], False
            with _post(base + "/chat/completions",
                       {**body, "stream": True}) as resp:
                for line in resp:
                    line = line.strip()
                    if not line.startswith(b"data: "):
                        continue
                    payload = line[len(b"data: "):]
                    if payload == b"[DONE]":
                        finished = True
                        break
                    delta = json.loads(payload)["choices"][0]["delta"]
                    pieces.append(delta.get("content", ""))
            assert finished and "".join(pieces) == want
            other = {**body, "messages": msgs("And then?")}
            json.loads(_post(base + "/chat/completions", other).read())
            assert _get(base + "/healthz") == {"status": "ok"}
            assert _get(base + "/models")["data"][0]["id"] == "m"
            metrics = _get(base + "/metrics")
            if mode:
                assert metrics["slots_total"] == 2
                assert metrics["prefix_hit_tokens"] > 0
                assert metrics["blocks_free"] > 0
            else:
                assert metrics == {"object": "metrics"}
        finally:
            server.shutdown()
            server.server_close()
