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
scales} / {qvalues, scales} leaves keep their bytes and dtypes; so does
a W8A8 CLIP tree's {qvalues_a8, scales} (quantize_params(a8=True)).

The grounding models keep the JAX package's nested-dict trees as they
are (tensors for arrays): tree_from_jax carries one across, checked
against the port's own random tree of the same model. The audio models
(Whisper with its tag head, wav2vec2) keep them too, with their layers
as lists and their conv kernels in torch's layout: whisper_from_jax and
wav2vec2_from_jax make those two changes, then tree_from_jax. So do
xmem_from_jax (the XMem network and its ResNet trunks: HWIO conv kernels
to OIHW weights) and clip_text_from_jax (the crop filter's text tower);
clip_vision_from_jax fills a CLIPVisionTower module. sam_from_jax (SAM
with its ViT image encoder) and ram_from_jax (RAM's tag decoder) carry
trees whose layout is the port's as it is, checked against the port's
own random tree of their configuration.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from video_llava_tpu_torch.config import VideoLLaVAConfig
from video_llava_tpu_torch.models.clip import a8_kernels_
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


_QUANT_LEAVES = ("qvalues_packed", "qvalues", "qvalues_a8", "scales")
_A8 = ".kernel.qvalues_a8"


def _a8_paths(flat: Dict[str, np.ndarray], prefix: str = "") -> list:
    """Module paths (under `prefix`, which is cut) of the W8A8 kernels
    ({qvalues_a8, scales}: quantize_params(a8=True)) of a flat tree."""
    return [k[len(prefix):-len(_A8)] for k in flat
            if k.startswith(prefix) and k.endswith(_A8)]


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


def tree_from_jax(tree_np, like, device=None,
                  dtype: Optional[torch.dtype] = None, path: str = ""):
    """A JAX parameter tree of numpy arrays (nested dicts and lists: the
    grounding models' GroundingDINO, Swin, BERT, TinyViT, SAM-decoder and
    tag-head trees) -> the same tree of tensors on `device` (floating
    leaves cast to `dtype` when given). `like` is the port's own tree of
    that model (its init_params on the meta device): every key, list
    length and leaf shape must match it."""
    if isinstance(like, dict):
        if not isinstance(tree_np, dict) or set(tree_np) != set(like):
            raise KeyError(f"{path or 'tree'}: keys "
                           f"{sorted(getattr(tree_np, 'keys', list)())} != "
                           f"{sorted(like)}")
        return {k: tree_from_jax(tree_np[k], like[k], device, dtype,
                                 f"{path}.{k}" if path else k)
                for k in like}
    if isinstance(like, (list, tuple)):
        if len(tree_np) != len(like):
            raise KeyError(f"{path}: {len(tree_np)} entries != {len(like)}")
        return [tree_from_jax(a, b, device, dtype, f"{path}.{i}")
                for i, (a, b) in enumerate(zip(tree_np, like))]
    t = _to_tensor(tree_np)
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"{path}: tree shape {tuple(t.shape)} != model "
                         f"shape {tuple(like.shape)}")
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_jax(tree_np, cfg: VideoLLaVAConfig, device=None,
                    dtype: Optional[torch.dtype] = None) -> VideoLLaVA:
    """Build a VideoLLaVA holding the JAX tree's values (floating leaves
    cast to `dtype` when given, else each leaf keeps its own dtype;
    quantized leaves always keep theirs). Every module parameter must be
    present in the tree and every tree leaf used."""
    flat = flatten_tree(tree_np)
    model_dtype = dtype or _to_tensor(flat["llm.final_norm.scale"]).dtype
    quant, group_size, fuse = llm_layout(flat)
    # a quantized LLM whose embedding stayed dense (training's int8 tree)
    skip = (("embed_tokens",) if quant and "llm.embed_tokens.weight" in flat
            else ())
    model = VideoLLaVA(cfg, device="meta", dtype=model_dtype,
                       llm_quant=quant, group_size=group_size,
                       llm_fuse=fuse, llm_skip_keys=skip)
    a8_kernels_(model.vision, _a8_paths(flat, "vision."))
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


# -- audio models ---------------------------------------------------------


def _unstack(stacked) -> list:
    """A scan-stacked layer tree (every leaf (NL, ...)) -> a list of NL
    per-layer trees."""
    flat = flatten_tree(stacked)
    n = len(np.asarray(next(iter(flat.values()))))
    layers = [{} for _ in range(n)]
    for path, leaf in flat.items():
        for i, row in enumerate(np.asarray(leaf)):
            node = layers[i]
            *head, last = path.split(".")
            for key in head:
                node = node.setdefault(key, {})
            node[last] = row
    return layers


def _conv_oiw(p) -> dict:
    """The JAX package's conv {'kernel': (width, in, out), 'bias'} ->
    {'weight': (out, in, width), 'bias'}."""
    return {"weight": np.asarray(p["kernel"]).transpose(2, 1, 0),
            "bias": p["bias"]}


def whisper_from_jax(tree_np, like, device=None,
                     dtype: Optional[torch.dtype] = None):
    """The JAX package's Whisper tree (numpy leaves; its at_head the
    linear probe or the TL-TR head) -> the port's tree (models/whisper.py
    layout) on `device`: the scan-stacked encoder and decoder layers
    split into lists, the conv stem's kernels transposed to (out, in,
    width). `like` is the port's own tree of the same configuration."""
    enc, dec = tree_np["encoder"], tree_np["decoder"]
    tree = {
        "encoder": {"conv1": _conv_oiw(enc["conv1"]),
                    "conv2": _conv_oiw(enc["conv2"]),
                    "layers": _unstack(enc["layers"]),
                    "ln_post": enc["ln_post"]},
        "decoder": {**dec, "layers": _unstack(dec["layers"])},
    }
    if "at_head" in tree_np:
        tree["at_head"] = tree_np["at_head"]
    return tree_from_jax(tree, like, device, dtype)


def wav2vec2_from_jax(tree_np, like, device=None,
                      dtype: Optional[torch.dtype] = None):
    """The JAX package's wav2vec2 tree (numpy leaves) -> the port's
    (models/wav2vec2.py layout) on `device`: the conv kernels (width,
    in / groups, out) transposed to (out, in / groups, width); the layer
    list stays a list."""
    tree = dict(tree_np)
    tree["convs"] = [{**c, "w": np.asarray(c["w"]).transpose(2, 1, 0)}
                     for c in tree_np["convs"]]
    tree["pos_conv_w"] = np.asarray(tree_np["pos_conv_w"]).transpose(2, 1, 0)
    return tree_from_jax(tree, like, device, dtype)


# -- grounding crop filter and propagator -------------------------------------


def clip_vision_from_jax(tree_np, cfg, device=None,
                         dtype: Optional[torch.dtype] = None):
    """The JAX package's CLIP vision tree (init_vision_params: stacked
    layers; W8A8 kernels of quantize_params(a8=True) too) -> a
    CLIPVisionTower of `cfg` holding its values (quantized leaves keep
    their dtype)."""
    from video_llava_tpu_torch.models.clip import CLIPVisionTower

    flat = flatten_tree(tree_np)
    tower = a8_kernels_(CLIPVisionTower(cfg, device="meta"),
                        _a8_paths(flat))
    expected = dict(tower.named_parameters())
    if set(flat) != set(expected):
        raise KeyError(f"tree does not match the tower: missing "
                       f"{sorted(set(expected) - set(flat))}, unexpected "
                       f"{sorted(set(flat) - set(expected))}")
    state = {}
    for name, param in expected.items():
        t = _to_tensor(flat[name])
        if tuple(t.shape) != tuple(param.shape):
            raise ValueError(f"{name}: tree shape {tuple(t.shape)} != "
                             f"tower shape {tuple(param.shape)}")
        keep = dtype is None or name.rsplit(".", 1)[-1] in _QUANT_LEAVES
        state[name] = t.to(device=device, dtype=t.dtype if keep else dtype)
    tower.load_state_dict(state, assign=True)
    return tower.requires_grad_(False)


def clip_text_from_jax(tree_np, like, device=None,
                       dtype: Optional[torch.dtype] = None):
    """The JAX package's CLIP text tree (init_text_params /
    convert_clip_text: stacked layers) -> the port's (models/clip.py
    init_text_params layout: a list of layers)."""
    return tree_from_jax({**tree_np, "layers": _unstack(tree_np["layers"])},
                         like, device, dtype)


def _convs_to_torch(tree):
    """Every conv {'kernel': (kh, kw, in, out), 'bias'} of a tree ->
    {'weight': (out, in, kh, kw), 'bias'}; other leaves as they are."""
    if isinstance(tree, (list, tuple)):
        return [_convs_to_torch(v) for v in tree]
    if not isinstance(tree, dict):
        return tree
    if "kernel" in tree and np.ndim(tree["kernel"]) == 4:
        out = {"weight": np.asarray(tree["kernel"]).transpose(3, 2, 0, 1)}
        if "bias" in tree:
            out["bias"] = tree["bias"]
        return out
    return {k: _convs_to_torch(v) for k, v in tree.items()}


def xmem_from_jax(tree_np, like, device=None,
                  dtype: Optional[torch.dtype] = None):
    """The JAX package's XMem (or ResNet trunk) tree -> the port's
    (models/xmem.py, models/resnet.py layout): conv kernels HWIO -> OIHW
    weights, the CBAM linears and BN statistics as they are."""
    return tree_from_jax(_convs_to_torch(tree_np), like, device, dtype)


# -- SAM's ViT encoder and RAM's tag decoder ----------------------------------


def sam_from_jax(tree_np, cfg, device=None,
                 dtype: Optional[torch.dtype] = None):
    """The JAX package's SAM tree (convert_hf_sam's: the ViT encoder
    under 'vision', the prompt encoder and mask decoder beside it) ->
    the port's (models/sam.py layout) on `device`."""
    from video_llava_tpu_torch.models import sam as sam_mod
    from video_llava_tpu_torch.models.layers import TreeInit

    meta = TreeInit(0, "meta")
    like = {"vision": sam_mod.init_vision_params(meta, cfg.vision),
            **sam_mod.init_decoder_params(meta, cfg)}
    # the mask decoder keeps as many two-way layers as the checkpoint had
    like["mask_decoder"]["layers"] = like["mask_decoder"]["layers"][:1] * len(
        tree_np["mask_decoder"]["layers"])
    return tree_from_jax(tree_np, like, device, dtype)


def ram_from_jax(tree_np, cfg, backbone_features: int, device=None,
                 dtype: Optional[torch.dtype] = None):
    """The JAX package's RAM decoder tree (init_params /
    convert_ram_checkpoint's, with or without query self-attention) ->
    the port's (models/ram.py layout) on `device`."""
    from video_llava_tpu_torch.models import ram as ram_mod
    from video_llava_tpu_torch.models.layers import TreeInit

    like = ram_mod.init_params(
        TreeInit(0, "meta"), cfg, backbone_features,
        self_attention="self" in tree_np["layers"][0])
    return tree_from_jax(tree_np, like, device, dtype)
