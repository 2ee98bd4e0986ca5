"""apply_projector_overlay (engine/weights.py): a projector written by
the port's export_projector (a linear, and an mlp2x_gelu), overlaid onto
another tiny VideoLLaVA: the projector and the embedding take the
checkpoint's values exactly, the report ({'applied', 'unexpected'})
equals the JAX package's on the same state dict, and a shorter embedding
grows by mean rows as there. With the embedding quantized (int8 rows, as
--quant gives it), the JAX overlay raises AttributeError (it reads
.shape of the quantized dict) while the port quantizes the checkpoint's
rows into the embedding's format."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from video_llava_tpu.config import ProjectorConfig as JaxProjectorConfig
from video_llava_tpu.engine import weights as jax_weights
from video_llava_tpu.ops.quant import quantize_params as jax_quantize
from video_llava_tpu_torch.config import LlamaConfig, VideoLLaVAConfig
from video_llava_tpu_torch.engine import weights
from video_llava_tpu_torch.engine.checkpoint import export_projector
from video_llava_tpu_torch.engine.convert import flatten_tree
from video_llava_tpu_torch.models.layers import Int8Kernel
from video_llava_tpu_torch.models.video_llava import VideoLLaVA
from video_llava_tpu_torch.ops.quant import quantize_tensor
from video_llava_tpu_torch.runtime.model_init import random_init_


def _model(cfg, seed, **kw):
    m = VideoLLaVA(cfg, device="cpu", dtype=torch.float32, **kw)
    random_init_(m, torch.Generator().manual_seed(seed))
    return m


def test_overlay_report_matches_jax_and_takes_quantized_embedding(tmp_path):
    for ptype in ("linear", "mlp2x_gelu"):
        base = VideoLLaVAConfig.tiny()
        cfg = dataclasses.replace(base, llm=LlamaConfig.tiny(vocab_size=300),
                                  projector_type=ptype)
        src, dst = _model(cfg, 1), _model(cfg, 2)
        path = str(tmp_path / f"{ptype}.bin")
        export_projector(src, path)
        sd = torch.load(path, weights_only=True)
        sd["model.layers.0.extra.weight"] = torch.zeros(2)
        report = weights.apply_projector_overlay(dst, sd)
        jcfg = JaxProjectorConfig(**dataclasses.asdict(cfg.projector))
        fake = {"projector": {}, "llm": {"embed_tokens": {
            "weight": jnp.zeros((300, cfg.llm.hidden_size))}}}
        np_sd = {k: v.numpy() for k, v in sd.items()}
        _, jreport = jax_weights.apply_projector_overlay(fake, np_sd, jcfg)
        assert report == jreport == {
            "applied": ["mm_projector", "embed_tokens"],
            "unexpected": ["model.layers.0.extra.weight"]}
        for (n, a), b in zip(dst.projector.named_parameters(),
                             src.projector.parameters()):
            assert torch.equal(a, b), n
        assert torch.equal(dst.llm.embed_tokens.weight,
                           src.llm.embed_tokens.weight)
        jnew, _ = jax_weights.apply_projector_overlay(
            {"projector": {}, "llm": fake["llm"]}, np_sd, jcfg)
        jflat = flatten_tree(jax.tree.map(np.asarray, jnew["projector"]))
        own = dict(dst.projector.named_parameters())
        assert set(jflat) == set(own)
        for n, a in own.items():
            np.testing.assert_array_equal(a.numpy(), jflat[n], err_msg=n)

    # a 290-row embedding grows by mean rows to the model's 300
    short = {k: v[:290] for k, v in sd.items() if "embed_tokens" in k}
    assert weights.apply_projector_overlay(dst, short) == {
        "applied": ["embed_tokens"], "unexpected": []}
    jnew, _ = jax_weights.apply_projector_overlay(
        fake, {k: v.numpy() for k, v in short.items()}, jcfg)
    want = np.asarray(jnew["llm"]["embed_tokens"]["weight"])
    np.testing.assert_allclose(dst.llm.embed_tokens.weight.numpy(), want,
                               atol=1e-7, rtol=0)

    # the quantized embedding: JAX raises, the port quantizes the rows
    qdst = _model(cfg, 2, llm_quant="int8")
    assert isinstance(qdst.llm.embed_tokens.weight, Int8Kernel)
    jq = {"projector": {}, "llm": jax_quantize(
        {"embed_tokens": {"weight": jnp.zeros((300, cfg.llm.hidden_size))}},
        min_size=0)}
    with pytest.raises(AttributeError):
        jax_weights.apply_projector_overlay(jq, np_sd, jcfg)
    assert weights.apply_projector_overlay(qdst, sd)["applied"] == [
        "mm_projector", "embed_tokens"]
    q, s = quantize_tensor(sd["model.embed_tokens.weight"], axis=1)
    assert torch.equal(qdst.llm.embed_tokens.weight.qvalues, q)
    assert torch.equal(qdst.llm.embed_tokens.weight.scales, s)
