"""The port's --quant resolution follows the JAX package's rules: the
same answer, or the same kind of error, for every argument against no
weights, weights without a record, and records choosing bf16, int8,
int4 or malformed."""

import json

from video_llava_tpu.engine.quant_select import resolve_quant as jresolve
from video_llava_tpu_torch.engine.quant_select import (
    resolve_quant as tresolve,
)


def _outcome(fn, quant, weights_dir):
    try:
        return ("value", fn(quant, weights_dir))
    except Exception as e:  # the kind of error is what must agree
        return ("error", type(e))


def test_resolve_quant_matches_jax(tmp_path):
    dirs = [None, str(tmp_path / "no_record")]
    (tmp_path / "no_record").mkdir()
    for name, rec in (("bf16", {"preflight_llm_format": "bf16"}),
                      ("int8", {"preflight_llm_format": "int8"}),
                      ("int4", {"preflight_llm_format": "int4"}),
                      ("bad", {"something": 1})):
        d = tmp_path / name
        d.mkdir()
        (d / "quant_preflight.json").write_text(json.dumps(rec))
        dirs.append(str(d))
    seen = set()
    for quant in (None, "auto", "int8", "int4", "fp8"):
        for d in dirs:
            got = _outcome(tresolve, quant, d)
            assert got == _outcome(jresolve, quant, d), (quant, d)
            seen.add(got)
    # every branch was reached: bf16, int8, int4 and three error kinds
    assert {("value", None), ("value", "int8"), ("value", "int4"),
            ("error", ValueError), ("error", FileNotFoundError)} <= seen
