"""The eval CLI from checkpoints: eval/run_inference.main with
--model_name, --projection_path and --clip_path (a tiny HF LLaMA
directory in safetensors shards with a tokenizer.json, a CLIPVisionModel
directory and an mm_projector.bin, written by tests/torch_ckpt_pair.py)
through each package's own initialize_model, against the JAX package's
main. The weights load in f32 on both sides with an f32 cache, and
decode greedily (set on the engine each initialize_model returns; the
batched runner's 128 new tokens), so the written JSON is held equal
field for field."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import torch

from torch_ckpt_pair import BASE_VOCAB, write_videollava_checkpoint
from video_llava_tpu.eval import run_inference as jax_ri
from video_llava_tpu.media.loader import encode_video
from video_llava_tpu_torch.config import VideoLLaVAConfig
from video_llava_tpu_torch.eval import run_inference


def _f32_greedy(init, dtype, built):
    """initialize_model loading in `dtype`, its engine decoding greedily
    with a cache in `dtype`; each engine appended to `built`."""
    def call(*args, **kwargs):
        engine = init(*args, dtype=dtype, **kwargs)
        engine.gen = dataclasses.replace(engine.gen, do_sample=False)
        engine.cache_dtype = dtype
        built.append(engine)
        return engine
    return call


def test_eval_main_loads_checkpoints_as_jax(tmp_path, monkeypatch):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # tiny CPU ops: more threads only contend
    try:
        _eval_main_loads_checkpoints_as_jax(tmp_path, monkeypatch)
    finally:
        torch.set_num_threads(threads)


def _eval_main_loads_checkpoints_as_jax(tmp_path, monkeypatch):
    paths = write_videollava_checkpoint(str(tmp_path / "ckpt"),
                                        VideoLLaVAConfig.tiny().vision)
    jax_built, built = [], []
    monkeypatch.setattr(jax_ri, "initialize_model", _f32_greedy(
        jax_ri.initialize_model, jnp.float32, jax_built))
    monkeypatch.setattr(run_inference, "initialize_model", _f32_greedy(
        run_inference.initialize_model, torch.float32, built))
    vdir = tmp_path / "videos"
    vdir.mkdir()
    rng = np.random.default_rng(3)
    for name, n in (("v_a1", 6), ("v_b2", 4), ("v_c3", 5)):
        encode_video(str(vdir / f"{name}.mp4"),
                     rng.integers(0, 255, size=(n, 64, 64, 3),
                                  dtype=np.uint8), fps=3, codec="mpeg4")
    questions = [{"question_id": f"q{i}", "video_name": n,
                  "question": q} for i, (n, q) in enumerate(
        (("a1", "What is it?"), ("b2", "Who is there?"),
         ("c3", "Describe the scene.")))]
    answers = [{"answer": a} for a in ("a cat", "nobody", "a room")]
    (tmp_path / "q.json").write_text(json.dumps(questions))
    (tmp_path / "a.json").write_text(json.dumps(answers))

    def args(out_dir):
        return ["--dataset", "activitynet", "--video_dir", str(vdir),
                "--gt_file_question", str(tmp_path / "q.json"),
                "--gt_file_answers", str(tmp_path / "a.json"),
                "--output_dir", str(out_dir), "--output_name", "preds",
                "--runner", "batched", "--batch_size", "2",
                "--model_size", "tiny", "--model_name", paths["llm"],
                "--projection_path", paths["projector"],
                "--clip_path", paths["clip"]]

    jax_ri.main(args(tmp_path / "jax"))
    got = run_inference.main(args(tmp_path / "port") + ["--device", "cpu"])
    want = json.loads((tmp_path / "jax" / "preds.json").read_text())
    written = json.loads((tmp_path / "port" / "preds.json").read_text())
    assert [r["id"] for r in want] == ["q0", "q1", "q2"]
    assert written == want and got == want
    # the checkpoint's tokenizer and weights, not the random fallback
    (engine,), (jax_engine,) = built, jax_built
    tok = engine.tokenizer
    assert (tok.vid_patch_token_id, tok.vid_end_token_id) == (
        jax_engine.tokenizer.vid_patch_token_id,
        jax_engine.tokenizer.vid_end_token_id) == (BASE_VOCAB,
                                                   BASE_VOCAB + 2)
    emb = engine.model.llm.embed_tokens.weight
    assert emb.dtype == torch.float32
    proj = torch.load(paths["projector"])
    assert torch.equal(emb[:BASE_VOCAB + 3],
                       proj["model.embed_tokens.weight"])
