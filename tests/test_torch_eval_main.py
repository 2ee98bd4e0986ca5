"""The port's eval CLI (eval/run_inference.main and its reference-named
aliases) against the JAX package's, on the same tiny weights."""

import json
import runpy
import sys

import numpy as np
import pytest
import torch

from torch_eval_pair import eval_pair  # noqa: F401 (fixture)
from video_llava_tpu.eval import run_inference as jax_ri
from video_llava_tpu.media.loader import encode_video
from video_llava_tpu_torch.eval import run_inference


def _stub_init(engine, calls):
    def init(*args, **kwargs):
        calls.append((args, kwargs))
        return engine
    return init


def test_eval_main_matches_jax(eval_pair, tmp_path, monkeypatch):
    """main(["--dataset", "activitynet", --runner batched ...]) on a CPU
    device and the MSVD alias (the sequential runner, run as a script)
    write the JSON the JAX package's main and alias write, field for
    field (exact: the same f32 weights, greedy), each model built through
    initialize_model (stood in for by the shared tiny engines) with the
    JAX CLI's layout flags and the port's --device; the checkpoint flags
    reach initialize_model as the JAX CLI passes them, and --mesh_model 2
    with the default nccl backend raises, naming --dist_backend, before
    any model is built or any rank is started (a card a rank; this host
    has none)."""
    # one torch thread: the tiny models' CPU ops gain nothing from more,
    # and beside the tier's other workers a pool of 8 spins on shared
    # cores (about 2x this test's time under load)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _eval_main_matches_jax(eval_pair, tmp_path, monkeypatch)
    finally:
        torch.set_num_threads(threads)


def _eval_main_matches_jax(eval_pair, tmp_path, monkeypatch):
    jax_engine, engine, _, _ = eval_pair
    jax_calls, calls = [], []
    monkeypatch.setattr(jax_ri, "initialize_model",
                        _stub_init(jax_engine, jax_calls))
    monkeypatch.setattr(run_inference, "initialize_model",
                        _stub_init(engine, calls))
    vdir = tmp_path / "videos"
    vdir.mkdir()
    rng = np.random.default_rng(1)
    for name, n in (("v_a1", 6), ("v_b2", 4), ("c3", 5)):
        encode_video(str(vdir / f"{name}.mp4"),
                     rng.integers(0, 255, size=(n, 64, 64, 3),
                                  dtype=np.uint8), fps=3, codec="mpeg4")
    questions = [{"question_id": f"q{i}", "video_name": n,
                  "question": q} for i, (n, q) in enumerate(
        (("a1", "What is it?"), ("zz", "Where?"), ("b2", "Who is there?")))]
    answers = [{"answer": a} for a in ("a cat", "home", "nobody")]
    (tmp_path / "q.json").write_text(json.dumps(questions))
    (tmp_path / "a.json").write_text(json.dumps(answers))
    flat = [{"video_name": "c3", "question": "Why?", "answer": "x", "id": 7},
            {"video_name": "a1", "question": "How?", "answer": "y", "id": 8}]
    (tmp_path / "msvd.json").write_text(json.dumps(flat))

    def args(out_dir):
        return ["--dataset", "activitynet", "--video_dir", str(vdir),
                "--gt_file_question", str(tmp_path / "q.json"),
                "--gt_file_answers", str(tmp_path / "a.json"),
                "--output_dir", str(out_dir), "--output_name", "preds",
                "--runner", "batched", "--batch_size", "2"]

    jax_ri.main(args(tmp_path / "jax"))
    got = run_inference.main(args(tmp_path / "port") + ["--device", "cpu"])
    want = json.loads((tmp_path / "jax" / "preds.json").read_text())
    written = json.loads((tmp_path / "port" / "preds.json").read_text())
    assert [r["id"] for r in want] == ["q0", "q2"]  # "zz" has no video
    assert written == want and got == want
    assert calls[0][1]["device"] == "cpu"
    for key in ("llm_quant", "llm_fuse", "model_size"):
        assert calls[0][1][key] == jax_calls[0][1][key], key

    # the MSVD alias as a script: the sequential runner over flat JSON
    def alias(pkg, out_dir, extra=()):
        monkeypatch.setattr(sys, "argv", [
            "x", "--video_dir", str(vdir), "--gt_file",
            str(tmp_path / "msvd.json"), "--output_dir", str(out_dir),
            "--output_name", "msvd", *extra])
        runpy.run_module(f"{pkg}.eval.runners.run_inference_qa_msvd",
                         run_name="__main__")
        return json.loads((out_dir / "msvd.json").read_text())

    want = alias("video_llava_tpu", tmp_path / "jax")
    assert [r["id"] for r in want] == [7]
    assert alias("video_llava_tpu_torch", tmp_path / "port",
                 ("--device", "cpu")) == want

    # the checkpoint flags reach initialize_model as the JAX CLI passes
    # them (tests/test_torch_model_init_ckpt.py holds the loads equal);
    # the stand-in stops each main once the model is asked for
    class Built(Exception):
        pass

    def stop(record):
        def init(*a, **kw):
            record.append((a, kw))
            raise Built
        return init

    monkeypatch.setattr(jax_ri, "initialize_model", stop(jax_calls))
    monkeypatch.setattr(run_inference, "initialize_model", stop(calls))
    flags = ["--model_name", "ckpt", "--projection_path", "p.bin",
             "--clip_path", "clip"]
    for main, out in ((jax_ri.main, "jax"), (run_inference.main, "port")):
        with pytest.raises(Built):
            main(args(tmp_path / out) + flags)
    assert calls[-1][0] == jax_calls[-1][0] == ("ckpt", "p.bin", "clip")
    n = len(calls)
    with pytest.raises(ValueError, match="--dist_backend"):
        run_inference.main(args(tmp_path / "port") + ["--mesh_model", "2"])
    assert len(calls) == n
