"""The entry points under --mesh_model 2 --dist_backend gloo --device
cpu on the tiny model (f32, --dtype float32): the serving CLI in a
process of its own (rank 0, which spawns rank 1 and follows the driver's
protocol, parallel/driver.py) answers one HTTP video chat request (the
frames decoded on rank 0 and sent with the replicated encode) through
the continuous engine over the paged pool, and the eval CLI's batched
runner answers one video sample, and the chat CLI's REPL (rank 0
reading the questions, the chat session replicated) answers one video
question; each answer equals the mesh-1 run's
(and the engine's chunk and accepted-token counters, the server's
/metrics, equal the mesh-1 engine's) (the
serving one in this process through the same engine; the eval one
through main itself, with speculation off as a mesh turns it off). The
server stops on SIGINT and takes its follower with it."""

import builtins
import json
import os
import signal
import subprocess
import sys
import time
import urllib.request

import numpy as np
import torch

from torch_xmem_pair import one_torch_thread
from video_llava_tpu_torch.eval import run_inference
from video_llava_tpu_torch.media.loader import encode_video
from video_llava_tpu_torch.runtime import chat
from video_llava_tpu_torch.runtime.model_init import initialize_model
from video_llava_tpu_torch.serving.server import (
    ChatModel,
    ContinuousChatModel,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
def _messages(video):
    return [{"role": "user", "content": [
        {"type": "text", "text": "What is happening?"},
        {"type": "video_url", "video_url": {"url": str(video)}}]}]


def _serve(tmp_path, messages):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "video_llava_tpu_torch.serving",
         "--model_size", "tiny", "--mesh_model", "2", "--dist_backend",
         "gloo", "--device", "cpu", "--dtype", "float32", "--port", "0",
         "--host", "127.0.0.1", "--continuous", "--paged",
         "--dist_init", f"file://{tmp_path}/serve_store"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    lines = []
    try:
        deadline = time.monotonic() + 120
        port = None
        while port is None and time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            if line.startswith("serving "):
                port = int(line.rsplit(":", 1)[1])
        assert port, "".join(lines)
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/chat/completions",
            data=json.dumps({"messages": messages, "temperature": 0.0,
                             "max_tokens": 16}).encode(),
            headers={"Content-Type": "application/json"})
        reply = json.loads(urllib.request.urlopen(req, timeout=120).read())
        reply["metrics"] = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/v1/metrics", timeout=30).read())
        proc.send_signal(signal.SIGINT)
        out, _ = proc.communicate(timeout=60)
        lines.append(out)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    return reply, proc.returncode, "".join(lines)


def _eval_args(tmp_path, out):
    return ["--dataset", "activitynet", "--video_dir",
            str(tmp_path / "videos"), "--gt_file_question",
            str(tmp_path / "q.json"), "--gt_file_answers",
            str(tmp_path / "a.json"), "--output_dir", str(tmp_path / out),
            "--output_name", "preds", "--runner", "batched", "--batch_size",
            "2", "--model_size", "tiny", "--device", "cpu", "--dtype",
            "float32"]


def _chat_answers(monkeypatch, capsys, argv, video):
    """The chat CLI's REPL over one video and one question -> its
    ASSISTANT>> lines."""
    lines = iter([str(video), "What is happening in the video?"])

    def read(prompt=""):
        try:
            return next(lines)
        except StopIteration:
            raise EOFError from None

    monkeypatch.setattr(builtins, "input", read)
    capsys.readouterr()
    chat.main(argv)
    return [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("ASSISTANT>>")]


@one_torch_thread()
def test_tp_serving_and_eval_match_mesh1(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    (tmp_path / "videos").mkdir()
    video = tmp_path / "videos" / "v_a1.mp4"
    rng = np.random.default_rng(1)
    encode_video(str(video),
                 rng.integers(0, 255, size=(6, 64, 64, 3), dtype=np.uint8),
                 fps=3, codec="mpeg4")
    reply, code, log = _serve(tmp_path, _messages(video))
    text = reply["choices"][0]["message"]["content"]
    engine = initialize_model(model_size="tiny", device="cpu",
                              dtype=torch.float32)
    model = ContinuousChatModel(
        ChatModel(model=engine.model, cfg=engine.cfg,
                  tokenizer=engine.tokenizer, conv_mode="vicuna_v1_1",
                  cache_dtype=torch.float32), paged=True)
    try:
        want = model.chat(_messages(video), temperature=0.0, max_tokens=16)
        stats = dict(model.engine.stats)
    finally:
        model.close()
    # the random tiny model's greedy ids decode to little text: the
    # engine's counters (speculative chunks and accepted tokens follow
    # the tokens drafted and verified) are compared too
    assert text == want, (text, want)
    for key in ("spec_chunks", "plain_chunks", "spec_tokens"):
        assert reply["metrics"][key] == stats[key], (key, reply, stats)
    assert stats["spec_tokens"] > 0
    # SIGINT ends rank 0 with its KeyboardInterrupt, after the driver
    # sent the follower home (it would raise "followers failed" else)
    assert code == -signal.SIGINT, log
    assert "KeyboardInterrupt" in log and "followers failed" not in log, log

    (tmp_path / "q.json").write_text(json.dumps(
        [{"question_id": "q0", "video_name": "a1",
          "question": "What is it?"}]))
    (tmp_path / "a.json").write_text(json.dumps([{"answer": "a cat"}]))
    init = run_inference.initialize_model

    def plain_decode(*a, **kw):
        built = init(*a, **kw)
        built.speculative = False
        return built

    monkeypatch.setattr(run_inference, "initialize_model", plain_decode)
    one = run_inference.main(_eval_args(tmp_path, "one"))
    monkeypatch.setattr(run_inference, "initialize_model", init)
    two = run_inference.main(_eval_args(tmp_path, "two") + [
        "--mesh_model", "2", "--dist_backend", "gloo", "--dist_init",
        f"file://{tmp_path}/eval_store"])
    assert [r["id"] for r in one] == ["q0"]
    assert one == two
    assert json.loads((tmp_path / "two" / "preds.json").read_text()) == two
    assert not torch.distributed.is_initialized()

    # the chat CLI: the REPL on rank 0, the session replicated
    argv = ["--model_size", "tiny", "--temperature", "0",
            "--max_output_tokens", "16", "--device", "cpu", "--dtype",
            "float32"]
    want = _chat_answers(monkeypatch, capsys, argv, video)
    got = _chat_answers(monkeypatch, capsys, argv + [
        "--mesh_model", "2", "--dist_backend", "gloo", "--dist_init",
        f"file://{tmp_path}/chat_store"], video)
    assert len(want) == 1 and got == want
    assert not torch.distributed.is_initialized()
