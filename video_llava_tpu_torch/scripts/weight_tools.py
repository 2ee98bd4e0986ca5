"""Weight tooling: delta computation and checkpoint consolidation.

Counterpart of video_llava_tpu/scripts/weight_tools.py. Parity:
reference video_chatgpt/model/make_delta.py:12-39 (target - base weight
diff, with top-left-corner subtraction for resized embeddings) and
consolidate.py:12-17 (re-save). Operates on flat state-dict files as
torch tensors in their stored dtype (bf16 checkpoints have no numpy
dtype), as the reference subtracts in the checkpoint's own dtype:
torch .bin / .pth through engine/weights' readers, .safetensors through
its own reader and writer (no safetensors package), .npz through numpy
(a bf16 tensor cannot be written there).

Run: python -m video_llava_tpu_torch.scripts.weight_tools make-delta \\
    --base b.bin --target t.bin --delta d.safetensors
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
import torch

from video_llava_tpu_torch.engine import weights as weights_mod

RESIZED_KEYS = ("model.embed_tokens.weight", "lm_head.weight")
PROJECTOR_KEYS = ("model.mm_projector.weight", "model.mm_projector.bias")

StateDict = Dict[str, torch.Tensor]


def _load(path: str) -> StateDict:
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: torch.from_numpy(z[k]) for k in z.files}
    if path.endswith(".safetensors"):
        return weights_mod.load_safetensors(path)
    if path.endswith((".pth", ".pt")):
        return weights_mod.load_torch_checkpoint_file(path)
    return weights_mod.load_torch_bin(path)


def _save(path: str, sd: StateDict) -> None:
    if path.endswith(".npz"):
        for k, v in sd.items():
            if v.dtype == torch.bfloat16:
                raise ValueError(f"{path}: {k} is bfloat16, which .npz "
                                 "cannot hold; write .safetensors or .bin")
        np.savez(path, **{k: v.detach().cpu().numpy() for k, v in sd.items()})
    elif path.endswith(".safetensors"):
        weights_mod.save_safetensors(path, sd)
    else:
        torch.save({k: v.detach().cpu().contiguous() for k, v in sd.items()},
                   path)


def make_delta(base: StateDict, target: StateDict) -> StateDict:
    """delta = target - base; resized embeddings subtract in the
    top-left corner; projector keys pass through."""
    delta = {}
    for name, param in target.items():
        if name not in base:
            assert name in PROJECTOR_KEYS or "mm_projector" in name, (
                f"{name} not in base model")
            delta[name] = param
            continue
        b = base[name]
        if param.shape == b.shape:
            delta[name] = param - b
        else:
            assert name in RESIZED_KEYS, f"{name} dimension mismatch"
            d = param.clone()
            d[: b.shape[0], : b.shape[1]] -= b
            delta[name] = d
    return delta


def apply_delta(base: StateDict, delta: StateDict) -> StateDict:
    """Inverse of make_delta."""
    out = {}
    for name, d in delta.items():
        if name not in base:
            out[name] = d
            continue
        b = base[name]
        if d.shape == b.shape:
            out[name] = d + b
        else:
            assert name in RESIZED_KEYS, f"{name} dimension mismatch"
            t = d.clone()
            t[: b.shape[0], : b.shape[1]] += b
            out[name] = t
    return out


def consolidate(src_path: str, dst_path: str) -> None:
    """Load + re-save (reference consolidate.py:12-17)."""
    _save(dst_path, _load(src_path))


def main(argv=None):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("make-delta")
    d.add_argument("--base", required=True)
    d.add_argument("--target", required=True)
    d.add_argument("--delta", required=True)
    a = sub.add_parser("apply-delta")
    a.add_argument("--base", required=True)
    a.add_argument("--delta", required=True)
    a.add_argument("--target", required=True)
    c = sub.add_parser("consolidate")
    c.add_argument("--src", required=True)
    c.add_argument("--dst", required=True)
    args = p.parse_args(argv)

    if args.cmd == "make-delta":
        _save(args.delta, make_delta(_load(args.base), _load(args.target)))
    elif args.cmd == "apply-delta":
        _save(args.target, apply_delta(_load(args.base), _load(args.delta)))
    else:
        consolidate(args.src, args.dst)
    print("done")


if __name__ == "__main__":
    main()
