"""`--quant` and CLIP dtype resolution against a checkpoint's preflight
record, by the rules of video_llava_tpu/engine/quant_select.py
(tests/test_torch_quant_select.py and test_torch_quant_select_clip.py
hold the two equal).

`python -m video_llava_tpu_torch.scripts.validate_quant_quality
--preflight --record` writes `quant_preflight.json` beside the weights.
`--quant auto` reads its decision; an explicit `--quant int4` on real
weights needs a record that approved int4, since int4's quality depends
on the checkpoint. The CLIP tower's W8A8 form reads the record's vision
entry the same way (:func:`resolve_clip_dtype`).
"""

from __future__ import annotations

import json
import os
from typing import Optional

RECORD_NAME = "quant_preflight.json"


def record_path(weights_dir: str) -> str:
    return os.path.join(weights_dir, RECORD_NAME)


def load_preflight(weights_dir: Optional[str]) -> Optional[dict]:
    """The preflight record in a checkpoint directory, or None."""
    if not weights_dir or not os.path.isfile(record_path(weights_dir)):
        return None
    with open(record_path(weights_dir)) as f:
        rec = json.load(f)
    if "preflight_llm_format" not in rec:
        raise ValueError(
            f"{record_path(weights_dir)} is not a preflight record "
            "(missing 'preflight_llm_format') — regenerate with "
            "validate_quant_quality --preflight --record")
    return rec


def resolve_quant(quant: Optional[str],
                  weights_dir: Optional[str]) -> Optional[str]:
    """'int8' | 'int4' | None (bf16) for a --quant argument.

    * None -> None.
    * 'auto' -> the recorded decision ('bf16' -> None); random weights
      (weights_dir None) -> 'int8'; a real checkpoint without a record
      is an error.
    * 'int4' -> on real weights, only with a record approving int4.
    * 'int8' -> always.
    """
    if quant is None:
        return None
    if quant not in ("auto", "int8", "int4"):
        raise ValueError(f"unknown quant {quant!r}")
    rec = load_preflight(weights_dir)
    if quant == "auto":
        if weights_dir is None:
            return "int8"
        if rec is None:
            raise FileNotFoundError(
                f"--quant auto needs {record_path(weights_dir)}; run "
                "python -m video_llava_tpu_torch.scripts."
                "validate_quant_quality "
                f"--weights {weights_dir} --preflight --record first")
        fmt = rec["preflight_llm_format"]
        return None if fmt == "bf16" else fmt
    if quant == "int4" and weights_dir is not None:
        if rec is None:
            raise FileNotFoundError(
                "--quant int4 without a preflight record: int4 quality "
                "is checkpoint-dependent. Run validate_quant_quality "
                "--preflight --record (or use --quant auto / int8). "
                f"Expected record: {record_path(weights_dir)}")
        if rec["preflight_llm_format"] != "int4":
            raise ValueError(
                f"preflight record chose {rec['preflight_llm_format']!r}, "
                "refusing --quant int4")
    return quant


def resolve_clip_dtype(clip_dtype: Optional[str],
                       weights_dir: Optional[str]) -> str:
    """'bf16' | 'int8' (the W8A8 tower) for a CLIP dtype request.

    * None / 'bf16' -> 'bf16'.
    * 'auto' -> the record's `preflight_vision_format` when it has one,
      else 'bf16' (a missing vision entry is no error: bf16 is always
      safe).
    * 'int8' -> on real weights, only with a record whose vision gate
      chose int8.
    """
    if clip_dtype in (None, "bf16"):
        return "bf16"
    if clip_dtype not in ("auto", "int8"):
        raise ValueError(f"unknown clip dtype {clip_dtype!r}")
    rec = load_preflight(weights_dir)
    fmt = (rec or {}).get("preflight_vision_format")
    if clip_dtype == "auto":
        return fmt if fmt in ("bf16", "int8") else "bf16"
    if weights_dir is not None:
        if fmt is None:
            raise FileNotFoundError(
                "--clip int8 without a vision preflight entry: run "
                "validate_quant_quality --vision --preflight --record "
                f"for {weights_dir} first (or use bf16/auto)")
        if fmt != "int8":
            raise ValueError(
                f"vision preflight chose {fmt!r}, refusing int8 CLIP "
                "(rerun the preflight with looser --min_vision_cos if "
                "intentional)")
    return "int8"
