"""The serving CLI's --batching, --max_batch and --window_ms reach
serve(), with the JAX CLI's defaults (8 and 30.0)."""

import torch

import video_llava_tpu_torch.serving.__main__ as cli
from video_llava_tpu_torch.runtime.model_init import initialize_model


def test_batching_flags_reach_serve(monkeypatch):
    """The model build is swapped for a tiny one on the CPU and serve()
    for a recorder: what the CLI would serve, and how."""
    built, served = [], []

    def build(**kw):
        built.append(kw)
        return initialize_model(model_size="tiny", device="cpu")

    monkeypatch.setattr(cli, "initialize_model", build)
    monkeypatch.setattr(cli, "serve",
                        lambda model, **kw: served.append((model, kw)))
    cli.main(["--model_size", "tiny", "--batching", "--max_batch", "3",
              "--window_ms", "12.5", "--port", "0"])
    cli.main(["--model_size", "tiny", "--batching"])
    cli.main(["--model_size", "tiny"])
    assert [kw["device"] for kw in built] == ["cuda"] * 3
    got = [(kw["batching"], kw["max_batch"], kw["window_ms"])
           for _, kw in served]
    assert got == [(True, 3, 12.5), (True, 8, 30.0), (False, 8, 30.0)]
    model, kw = served[0]
    assert kw["port"] == 0 and not kw["continuous"]
    assert model.speculative and model.cache_dtype == torch.bfloat16
