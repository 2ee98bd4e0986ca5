"""Port parity: scripts/validate_quant_quality --self_test --preflight
--record in both packages, the port's on the JAX self-test's own weights
carried across (the tiny bf16 LLM and CLIP tower)."""

import json

import jax
import numpy as np
import torch

from video_llava_tpu.config import CLIPVisionConfig as JaxVisionConfig
from video_llava_tpu.models import clip as jax_clip
from video_llava_tpu.scripts import validate_quant_quality as jvq
from video_llava_tpu_torch.engine.convert import (
    _to_tensor,
    clip_vision_from_jax,
    flatten_tree,
)
from video_llava_tpu_torch.engine.quant_select import (
    resolve_clip_dtype,
    resolve_quant,
)
from video_llava_tpu_torch.models.llama import Llama
from video_llava_tpu_torch.scripts import validate_quant_quality as tvq


def _keys(tree, prefix=""):
    if not isinstance(tree, dict):
        return {prefix}
    return set().union(*(_keys(v, f"{prefix}/{k}") for k, v in tree.items()))


def test_self_test_record_matches_jax(tmp_path, monkeypatch):
    """Both packages write a record with the same keys and the same
    decisions. Metrics: the bf16 forwards differ in summation order and
    bf16 roundings (perplexity ~1,650 over 3,968 tokens: its rel. limit
    2e-3); int8 and int4 quantize the same bf16 weights to the same
    values, but a weight or activation on a rounding tie may land apart,
    so top-1 agreement (argmax over 1,024 near-flat random logits) may
    differ on a few tokens (limit 0.02 of 3,968) and the mean KL by 10%;
    the vision cosines within 1e-4 (64 tokens, W8A8 on a 3-layer
    tower). Measured: perplexity 1.4e-4, 2e-5, 3e-4 apart (bf16, int8,
    int4), top-1 0.0045, KL 0.4%, cosines 7e-6."""
    torch.set_num_threads(1)
    jrec, trec = tmp_path / "jax.json", tmp_path / "port.json"
    assert jvq.main(["--self_test", "--preflight", "--record",
                     str(jrec)]) == 0

    params, _, _ = jvq._load_self_test()
    llm = Llama(tvq.SELF_TEST_LLM, device="meta", dtype=torch.bfloat16)
    llm.load_state_dict({k: _to_tensor(v) for k, v in flatten_tree(
        jax.tree.map(np.asarray, params)).items()}, assign=True)
    ids = np.asarray(np.random.default_rng(0).integers(0, 1024, size=4096),
                     np.int32)
    vcfg = JaxVisionConfig(image_size=32, patch_size=16, hidden_size=64,
                           intermediate_size=128, num_layers=3, num_heads=4)
    vparams = jax.jit(lambda k: jax_clip.init_vision_params(
        k, vcfg, jax.numpy.bfloat16))(jax.random.PRNGKey(1))
    tower = clip_vision_from_jax(jax.tree.map(np.asarray, vparams),
                                 tvq.SELF_TEST_VISION)
    monkeypatch.setattr(tvq, "_load_self_test",
                        lambda device: (llm.requires_grad_(False), ids))
    monkeypatch.setattr(tvq, "_self_test_tower", lambda device: tower)
    assert tvq.main(["--self_test", "--preflight", "--record", str(trec),
                     "--device", "cpu"]) == 0

    want, got = json.loads(jrec.read_text()), json.loads(trec.read_text())
    assert _keys(got) == _keys(want)
    for key in ("preflight_llm_format", "preflight_vision_format",
                "max_ppl_delta_pct", "min_top1", "min_vision_cos",
                "vision_weights_real"):
        assert got[key] == want[key], key
    for fmt, m in want["metrics"].items():
        g = got["metrics"][fmt]
        assert g["tokens_scored"] == m["tokens_scored"] == 3968
        assert abs(g["perplexity"] / m["perplexity"] - 1) < 2e-3, fmt
        if fmt != "bf16":
            assert abs(g["top1_agreement_vs_bf16"]
                       - m["top1_agreement_vs_bf16"]) < 0.02, fmt
            assert abs(g["mean_kl_vs_bf16"] / m["mean_kl_vs_bf16"]
                       - 1) < 0.1, fmt
    for key in ("feature_cos_mean", "feature_cos_p5"):
        assert abs(got["vision_metrics"][key]
                   - want["vision_metrics"][key]) < 1e-4, key
    assert got["vision_metrics"]["tokens"] == want["vision_metrics"][
        "tokens"]

    # the port's resolvers read the port's record back
    (tmp_path / "quant_preflight.json").write_text(trec.read_text())
    fmt = got["preflight_llm_format"]
    assert resolve_quant("auto", str(tmp_path)) == (
        None if fmt == "bf16" else fmt)
    assert resolve_clip_dtype("auto", str(tmp_path)) == got[
        "preflight_vision_format"]
