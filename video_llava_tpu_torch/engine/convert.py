"""Carry a JAX parameter tree into the port's modules.

The JAX package keeps its parameters as nested dicts with the encoder
and decoder layers stacked along a leading axis (``models/clip.py``
init_vision_params, ``models/llama.py`` init_params). The port's
modules use the same leaf names, one module per layer, so a tree maps
onto ``VideoLLaVA.state_dict()`` by path once each stacked ``layers``
dict is split. Leaves arrive as numpy arrays (for example
``jax.tree.map(np.asarray, params)``), so nothing here imports JAX;
bfloat16 leaves (numpy's ml_dtypes bfloat16) are carried bit for bit.
A quantized LLM tree (quantize_params / quantize_params_int4, then
optionally fuse_layer_kernels) carries across as it is: the model is
built in the layout the tree's leaves name, and the {qvalues_packed,
scales} / {qvalues, scales} leaves keep their bytes and dtypes.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from video_llava_tpu_torch.config import VideoLLaVAConfig
from video_llava_tpu_torch.models.llama import FUSED
from video_llava_tpu_torch.models.video_llava import VideoLLaVA


def _to_tensor(a) -> torch.Tensor:
    a = np.array(a, order="C")  # a writable copy: the tree may be read-only
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def flatten_tree(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """{'a': {'layers': {'q': {'kernel': (NL, ...)}}}} ->
    {'a.layers.0.q.kernel': ..., 'a.layers.1.q.kernel': ...}: a dict under
    the key 'layers' is layer-stacked and splits along axis 0; a list
    (the projector's layers) indexes as it is."""
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        out[prefix] = tree
        return out
    for key, value in items:
        path = f"{prefix}.{key}" if prefix else str(key)
        if key == "layers" and isinstance(value, dict):
            for name, leaf in flatten_tree(value).items():
                for i, row in enumerate(np.asarray(leaf)):
                    out[f"{path}.{i}.{name}"] = row
        else:
            out.update(flatten_tree(value, path))
    return out


_QUANT_LEAVES = ("qvalues_packed", "qvalues", "scales")


def llm_layout(flat: Dict[str, np.ndarray]):
    """(llm_quant, group_size, llm_fuse) of a flattened tree's LLM."""
    keys = [k for k in flat if k.startswith("llm.")]
    packed = [k for k in keys if k.endswith(".qvalues_packed")]
    quant = ("int4" if packed else
             "int8" if any(k.endswith(".qvalues") for k in keys) else None)
    group_size = 128
    if packed:
        d = 2 * np.shape(flat[packed[0]])[-2]
        g = np.shape(flat[packed[0][:-len("qvalues_packed")] + "scales"])[-2]
        group_size = d // g if g > 1 else None
    fuse = any(f".{name}." in k for k in keys for name in FUSED)
    return quant, group_size, fuse


def params_from_jax(tree_np, cfg: VideoLLaVAConfig, device=None,
                    dtype: Optional[torch.dtype] = None) -> VideoLLaVA:
    """Build a VideoLLaVA holding the JAX tree's values (floating leaves
    cast to `dtype` when given, else each leaf keeps its own dtype;
    quantized leaves always keep theirs). Every module parameter must be
    present in the tree and every tree leaf used."""
    flat = flatten_tree(tree_np)
    model_dtype = dtype or _to_tensor(flat["llm.final_norm.scale"]).dtype
    quant, group_size, fuse = llm_layout(flat)
    model = VideoLLaVA(cfg, device="meta", dtype=model_dtype,
                       llm_quant=quant, group_size=group_size,
                       llm_fuse=fuse)
    expected = dict(model.named_parameters())
    missing = sorted(set(expected) - set(flat))
    unexpected = sorted(set(flat) - set(expected))
    if missing or unexpected:
        raise KeyError(f"tree does not match the model: missing {missing}, "
                       f"unexpected {unexpected}")
    state = {}
    for name, param in expected.items():
        t = _to_tensor(flat[name])
        if tuple(t.shape) != tuple(param.shape):
            raise ValueError(f"{name}: tree shape {tuple(t.shape)} != "
                             f"model shape {tuple(param.shape)}")
        keep = dtype is None or name.rsplit(".", 1)[-1] in _QUANT_LEAVES
        state[name] = t.to(device=device, dtype=t.dtype if keep else dtype)
    model.load_state_dict(state, assign=True)
    for p in model.parameters():
        p.requires_grad_(False)
    return model
