"""The port's CLIP dtype resolution follows the JAX package's rules: the
same answer, or the same error with the same message, for every request
against no weights, weights without a record, and records with and
without a vision entry; initialize_model(clip_dtype=...) goes through
it."""

import json

import pytest
import torch

from video_llava_tpu.engine.quant_select import (
    resolve_clip_dtype as jresolve,
)
from video_llava_tpu_torch.engine.quant_select import (
    resolve_clip_dtype as tresolve,
)
from video_llava_tpu_torch.runtime.model_init import initialize_model


def _outcome(fn, clip_dtype, weights_dir):
    try:
        return ("value", fn(clip_dtype, weights_dir))
    except Exception as e:  # the kind of error and its message agree
        return ("error", type(e), str(e))


def test_resolve_clip_dtype_matches_jax(tmp_path):
    dirs = [None, str(tmp_path / "no_record")]
    (tmp_path / "no_record").mkdir()
    for name, rec in (
            ("llm_only", {"preflight_llm_format": "int4"}),
            ("vision_bf16", {"preflight_llm_format": "int8",
                             "preflight_vision_format": "bf16"}),
            ("vision_int8", {"preflight_llm_format": "bf16",
                             "preflight_vision_format": "int8"}),
            ("vision_odd", {"preflight_llm_format": "int8",
                            "preflight_vision_format": "fp8"}),
            ("bad", {"preflight_vision_format": "int8"})):
        d = tmp_path / name
        d.mkdir()
        (d / "quant_preflight.json").write_text(json.dumps(rec))
        dirs.append(str(d))
    seen = set()
    for clip_dtype in (None, "bf16", "auto", "int8", "fp8"):
        for d in dirs:
            got = _outcome(tresolve, clip_dtype, d)
            assert got == _outcome(jresolve, clip_dtype, d), (clip_dtype, d)
            seen.add(got[:2])
    # every branch: bf16, int8 and three kinds of error
    assert {("value", "bf16"), ("value", "int8"), ("error", ValueError),
            ("error", FileNotFoundError)} <= seen

    # initialize_model resolves through it: an unknown dtype raises; a
    # tiny tower's kernels ((2, 64, 64) stacked) fall under the JAX
    # min_size of 1 << 16 elements and stay dense, as in the JAX package
    with pytest.raises(ValueError, match="unknown clip dtype"):
        initialize_model(model_size="tiny", device="cpu", clip_dtype="fp8")
    engine = initialize_model(model_size="tiny", device="cpu",
                              clip_dtype="int8")
    assert all(isinstance(layer.q.kernel, torch.Tensor)
               for layer in engine.model.vision.layers)
