"""media/scene.py's detect_scenes and grounding/entity_matching.py
against the JAX package: scene bounds on a seeded clip with two hard cuts
and a gradual stretch (equal), the content values (1e-4), the match
response parser on edge cases (equal highlights and match_state), and
the matcher's request through a stub client (the same messages). The
port's urllib client is checked against a local HTTP server: a 503 with
Retry-After is retried, a 400 is not."""

import json
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np
import pytest

from video_llava_tpu.grounding import entity_matching as jem
from video_llava_tpu.media import scene as jscene
from video_llava_tpu_torch.eval.openai_client import ChatCompletionClient
from video_llava_tpu_torch.grounding import entity_matching as tem
from video_llava_tpu_torch.media import scene as tscene
from torch_grounding_pair import StubClient, moving_squares


def test_scenes_and_entity_matching_match_jax():
    rng = np.random.default_rng(0)
    clip = np.concatenate([
        moving_squares(8, 48, 64, seed=1),
        rng.integers(0, 256, (1, 48, 64, 3), dtype=np.uint8),  # one-frame
        moving_squares(9, 48, 64, seed=2)])
    clip[13:] = (clip[13:] * np.linspace(1, 0.6, 5)[:, None, None, None]
                 ).astype(np.uint8)  # a fade
    assert tscene.detect_scenes(clip) == jscene.detect_scenes(clip)
    assert len(tscene.detect_scenes(clip)) >= 2
    assert tscene.detect_scenes(clip[:0]) == []
    np.testing.assert_allclose(tscene.content_values(clip),
                               jscene.content_values(clip), atol=1e-4)

    text = "A brown dog runs after a red ball; the dog jumps. Grass."
    entities = ["dog", "ball", "grass", "sky"]
    for answer in ("brown dog - dog\nred ball - ball",
                   "dog - dog\nthe dog - dog\nsky - sky\nno pair here",
                   "Grass - grass\n a brown dog  -  dog ",
                   "cat - cat", ""):
        assert tem.parse_match_response(answer, text, entities) == \
            jem.parse_match_response(answer, text, entities)
    stubs = StubClient(n=3), StubClient(n=3)
    got = tem.EntityMatchingModule(client=stubs[0])(text, entities)
    want = jem.EntityMatchingModule(client=stubs[1])(text, entities)
    assert got == want and stubs[0].requests == stubs[1].requests
    assert set(got[1].values()) == {"dog", "ball", "grass"}


class _Handler(BaseHTTPRequestHandler):
    replies = []

    def do_POST(self):
        body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        status, payload = self.replies.pop(0)
        self.send_response(status)
        if status == 503:
            self.send_header("Retry-After", "0.01")
        self.end_headers()
        self.wfile.write(json.dumps(payload or {"choices": [{"message": {
            "content": body["messages"][-1]["content"]}}]}).encode())

    def log_message(self, *a):
        pass


def test_zz_urllib_client_retries():  # second test: not in the fast tier
    server = HTTPServer(("127.0.0.1", 0), _Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_port}/v1"
    try:
        sleeps = []
        client = ChatCompletionClient(api_base=base, sleep=sleeps.append)
        _Handler.replies[:] = [(503, {"error": "busy"}), (200, None)]
        assert client.chat_text("m", [{"role": "user",
                                       "content": "hi"}]) == "hi"
        assert sleeps == [0.01]
        _Handler.replies[:] = [(400, {"error": "bad"})]
        with pytest.raises(Exception) as e:
            client.chat_text("m", [{"role": "user", "content": "x"}])
        assert getattr(e.value, "code", None) == 400
    finally:
        server.shutdown()
