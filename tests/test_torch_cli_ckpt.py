"""The chat and serving CLIs from checkpoints, against the JAX package's:
each main builds its model through its own package's initialize_model
from a tiny HF LLaMA directory (safetensors shards, a tokenizer.json and
a quant_preflight.json approving int4), a CLIPVisionModel directory and
an mm_projector.bin (tests/torch_ckpt_pair.py).

- chat (`--model-name`, `--projection_path`, `--clip_path`,
  `--temperature 0`), its REPL fed a video path and a question: the
  weights loaded in f32 on both sides (the CLI builds bf16; a wrapper
  around initialize_model asks for f32, and for the CPU on the port's
  side, since the CLI asks for the card), greedy for 16 tokens, the
  ASSISTANT line equal to the JAX CLI's.
- serving (`--model_name`, `--quant int4`), the network server stood in
  for by a recorder of the ChatModel it is handed: every leaf of the
  served LLM, int4 fused as the CLI builds it on one chip, equal to
  the JAX CLI's carried across by engine/convert.py (exact, but the
  mean-initialised rows of the embedding and lm_head, within one bf16
  ulp: an f32 mean summed in another order, then rounded), and the
  tokenizer's video ids the checkpoint's."""

import builtins
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from torch_ckpt_pair import BASE_VOCAB, write_videollava_checkpoint
from video_llava_tpu.media.loader import encode_video
from video_llava_tpu.runtime import chat as jax_chat
from video_llava_tpu.serving import __main__ as jax_serving
from video_llava_tpu_torch.config import VideoLLaVAConfig
from video_llava_tpu_torch.engine.convert import params_from_jax
from video_llava_tpu_torch.runtime import chat
from video_llava_tpu_torch.serving import __main__ as serving

ULP = 2.0 ** -7  # one bf16 ulp, relative


def _scripted_input(lines):
    it = iter(lines)

    def read(prompt=""):
        try:
            return next(it)
        except StopIteration:
            raise EOFError from None
    return read


def _answers(out: str):
    return [ln for ln in out.splitlines() if ln.startswith("ASSISTANT>>")]


def test_chat_and_serving_clis_load_checkpoints_as_jax(tmp_path, monkeypatch,
                                                       capsys):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # tiny CPU ops: more threads only contend
    try:
        _clis_load_checkpoints_as_jax(tmp_path, monkeypatch, capsys)
    finally:
        torch.set_num_threads(threads)


def _clis_load_checkpoints_as_jax(tmp_path, monkeypatch, capsys):
    paths = write_videollava_checkpoint(str(tmp_path / "ckpt"),
                                        VideoLLaVAConfig.tiny().vision)
    with open(os.path.join(paths["llm"], "quant_preflight.json"), "w") as f:
        json.dump({"preflight_llm_format": "int4"}, f)
    video = str(tmp_path / "clip.mp4")
    encode_video(video, np.random.default_rng(4).integers(
        0, 255, size=(5, 64, 64, 3), dtype=np.uint8), fps=3, codec="mpeg4")

    # chat: the REPL's answer
    real_jax, real = jax_chat.initialize_model, chat.initialize_model
    monkeypatch.setattr(jax_chat, "initialize_model", lambda *a, **kw:
                        real_jax(*a, dtype=jnp.float32, **kw))
    monkeypatch.setattr(chat, "initialize_model", lambda *a, **kw: real(
        *a, **{**kw, "device": "cpu", "dtype": torch.float32}))
    argv = ["--model-name", paths["llm"], "--projection_path",
            paths["projector"], "--clip_path", paths["clip"],
            "--model_size", "tiny", "--temperature", "0",
            "--max_output_tokens", "16"]
    said = []
    for main in (jax_chat.main, chat.main):
        monkeypatch.setattr(builtins, "input", _scripted_input(
            [video, "What is happening in the video?"]))
        capsys.readouterr()
        main(argv)
        said.append(_answers(capsys.readouterr().out))
    assert len(said[0]) == 1 and len(said[0][0]) > len("ASSISTANT>> ")
    assert said[1] == said[0]

    # serving: the model the server is handed
    served = []
    for mod in (jax_serving, serving):
        monkeypatch.setattr(mod, "serve", lambda model, **kw:
                            served.append(model))
    monkeypatch.setattr(serving, "initialize_model",
                        lambda *a, initialize=serving.initialize_model,
                        **kw: initialize(*a, **{**kw, "device": "cpu"}))
    argv = ["--model_name", paths["llm"], "--model_size", "tiny",
            "--quant", "int4"]
    jax_serving.main(argv)
    serving.main(argv)
    jax_model, model = served
    for tok in (model.tokenizer, jax_model.tokenizer):
        assert (tok.vid_patch_token_id, tok.vid_start_token_id,
                tok.vid_end_token_id) == (BASE_VOCAB, BASE_VOCAB + 1,
                                          BASE_VOCAB + 2)
    # the LLM: the checkpoint's (the CLI loads no CLIP or projector, so
    # each package draws those from its own generator)
    carried = {n: p for n, p in params_from_jax(
        jax.tree.map(np.asarray, jax_model.params), model.cfg)
        .named_parameters() if n.startswith("llm.")}
    own = {n: p for n, p in model.model.named_parameters()
           if n.startswith("llm.")}
    assert set(own) == set(carried)
    assert any(n.endswith("qvalues_packed") for n in own)  # int4 packed
    for name, p in own.items():
        q = carried[name]
        assert p.dtype == q.dtype and p.shape == q.shape, name
        rows = "embed_tokens.weight" in name or "lm_head.kernel" in name
        if rows and p.is_floating_point():
            err = (p.float() - q.float()).abs().amax().item()
            assert err <= ULP * q.float().abs().amax().item(), (name, err)
        else:
            assert torch.equal(p, q), name
