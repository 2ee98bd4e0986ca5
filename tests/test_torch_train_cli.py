"""The port's training entry point (python -m
video_llava_tpu_torch.train.train) on the CPU at the tiny size: steps,
periodic and final checkpoints, the projector exports, the summary, the
profile of step 3, and resuming."""

import json
import math
import os

import numpy as np
import pytest
import torch

from video_llava_tpu_torch.runtime.model_init import model_config
from video_llava_tpu_torch.train import train


def _write_data(tmp_path, n: int = 8):
    cfg = model_config("tiny")
    folder = tmp_path / "feats"
    folder.mkdir()
    rng = np.random.default_rng(0)
    samples = []
    for i in range(n):
        np.save(folder / f"v{i}.npy", rng.standard_normal(
            (cfg.video_token_len, cfg.vision.hidden_size)).astype(np.float32))
        samples.append({"video": f"v{i}.npy", "conversations": [
            {"from": "human", "value": "<video>\nWhat happens?"},
            {"from": "gpt", "value": "A cat walks. " * (1 + i % 3)}]})
    path = tmp_path / "data.json"
    path.write_text(json.dumps(samples))
    return str(path), str(folder)


def _state(out, step):
    return torch.load(os.path.join(out, f"checkpoint-{step}", "state.pt"),
                      weights_only=True)


def test_train_cli_runs_saves_exports_and_resumes(tmp_path, capsys,
                                                  monkeypatch):
    """8 samples, batch 2, one epoch: 4 steps, checkpoints and projector
    exports at steps 2 and 4, the final mm_projector.bin (the reference
    export's keys) and train_summary.json with finite losses, and a
    torch.profiler trace of step 3. Between the checkpoints the projector
    and embed_tokens moved and a frozen layer did not. A second call
    resumes from checkpoint-4 and takes steps 5 to 8. Mesh flags that
    ask for a grid larger than the world raise ValueError (sharded
    training itself: tests/test_torch_dp_train_cli.py); --pretrained_dir
    builds the LLM as the JAX trainer does."""
    data, feats = _write_data(tmp_path)
    out, prof = str(tmp_path / "out"), str(tmp_path / "prof")
    argv = ["--data_path", data, "--video_folder", feats, "--output_dir", out,
            "--model_size", "tiny", "--device", "cpu",
            "--per_device_train_batch_size", "2", "--num_train_epochs", "1",
            "--save_steps", "2", "--warmup_ratio", "0.25"]
    summary = train.main(argv + ["--profile", prof])
    assert summary["steps"] == 4 and len(summary["loss"]) == 4
    assert all(math.isfinite(x) for x in summary["loss"] + summary[
        "grad_norm"])
    assert os.path.getsize(os.path.join(prof, "trace.json")) > 0
    with open(os.path.join(out, "train_summary.json")) as f:
        assert json.load(f)["steps"] == 4
    for step in (2, 4):
        assert os.path.exists(os.path.join(out, "mm_projector",
                                           f"checkpoint-{step}.bin"))
    export = torch.load(os.path.join(out, "mm_projector.bin"))
    assert sorted(export) == ["model.embed_tokens.weight",
                              "model.mm_projector.bias",
                              "model.mm_projector.weight"]
    s2, s4 = _state(out, 2), _state(out, 4)
    assert s4["step"] == 4 and s4["opt_state"]["count"] == 4
    for key, moved in (("projector.layers.0.kernel", True),
                       ("llm.embed_tokens.weight", True),
                       ("llm.layers.1.wq.kernel", False),
                       ("llm.lm_head.kernel", False)):
        assert torch.equal(s2["params"][key], s4["params"][key]) != moved, key
    np.testing.assert_array_equal(
        export["model.mm_projector.weight"].numpy(),
        s4["params"]["projector.layers.0.kernel"].float().t().numpy())
    capsys.readouterr()

    summary = train.main(argv)
    assert "resuming from" in capsys.readouterr().out
    assert summary["steps"] == 8 and len(summary["loss"]) == 4
    assert _state(out, 8)["opt_state"]["count"] == 8

    # a grid larger than the world (torchrun's one rank here) raises
    # before anything runs
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    for extra in (["--mesh_data", "2"], ["--mesh_model", "2"]):
        with pytest.raises(ValueError, match="exceeds|not divisible"):
            train.main(argv + extra)
    monkeypatch.delenv("WORLD_SIZE")
    monkeypatch.delenv("RANK")

    # --pretrained_dir: the LLM from an HF LLaMA directory, as the JAX
    # trainer builds it (convert_llama in bf16, then with --llm_weights
    # int8 quantize_params with embed_tokens kept): every leaf equal but
    # for the mean-initialised vocabulary rows, within one bf16 ulp of
    # the row's scale
    import jax
    import jax.numpy as jnp
    from torch_ckpt_pair import BASE_VOCAB, hf_llama, write_shards
    from video_llava_tpu.config import LlamaConfig as JaxLlamaConfig
    from video_llava_tpu.engine import weights as jax_weights
    from video_llava_tpu.ops.quant import quantize_params
    from video_llava_tpu_torch.engine.convert import flatten_tree

    ckpt = str(tmp_path / "llama")
    write_shards(ckpt, hf_llama().state_dict(), "bin", shards=2)
    cfg = model_config("tiny")
    jllm = jax_weights.convert_llama(
        jax_weights.load_checkpoint_dir(ckpt),
        JaxLlamaConfig(**cfg.llm.__dict__), jnp.bfloat16)
    for fmt in ("bf16", "int8"):
        args = train.parse_args(argv + ["--pretrained_dir", ckpt,
                                        "--llm_weights", fmt])
        model = train.build_model(args, cfg, "cpu")
        ref = jllm if fmt == "bf16" else quantize_params(jllm, skip_keys=(
            "class_embedding", "position_embedding", "embed_tokens"))
        want = flatten_tree(jax.tree.map(np.asarray, ref))
        own = dict(model.llm.named_parameters())
        assert set(own) == set(want)
        for name, p in own.items():
            w = torch.from_numpy(np.array(want[name]).view(np.int16)).view(
                torch.bfloat16) if want[name].dtype.name == "bfloat16" \
                else torch.from_numpy(np.array(want[name]))
            assert p.dtype == w.dtype and p.shape == w.shape, name
            if "embed_tokens" in name or "lm_head" in name:
                old = (slice(None, BASE_VOCAB) if "embed" in name
                       else (..., slice(None, BASE_VOCAB)))
                assert torch.equal(p[old], w[old]), name
                err = (p.float() - w.float()).abs().amax().item()
                assert err <= 2 ** -7 * w.float().abs().amax().item() + (
                    1 if p.dtype == torch.int8 else 0), (name, err)
            else:
                assert torch.equal(p, w), name
