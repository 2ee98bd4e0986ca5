"""HF checkpoint -> the port's modules.

Counterpart of video_llava_tpu/engine/weights.py, with the reference's
loading semantics:
  * Vicuna/LLaMA and the CLIP towers from HF state dicts
    (video_chatgpt/eval/model_utils.py:101-137);
  * the embedding resize with mean-init of the added video-token rows
    (video_chatgpt/model/video_chatgpt.py:294-305);
  * the non-strict projector overlay from mm_projector.bin: matching
    keys applied, the others reported (model_utils.py:119-127).

Files are read without the `safetensors` package: :func:`load_safetensors`
parses the header itself and memory-maps the data, and every reader
returns torch tensors in the file's dtype (no f32 copy of a 7B model in
host memory). :func:`checkpoint_shards` yields a checkpoint directory one
shard at a time. The converters write each tensor straight into the
port's module on the module's device, cast to the module's dtype there,
one layer at a time: :func:`convert_llama` holds a layer's seven
kernels until the layer is whole, then (for a quantized module)
quantizes and fuses them on the device as the module's layout says, so
no whole bf16 LLM is ever built.
"""

from __future__ import annotations

import functools
import json
import os
import re
import struct
from typing import Dict, Iterable, Iterator, List, Optional, Union

import numpy as np
import torch

from video_llava_tpu_torch.engine.convert import flatten_tree
from video_llava_tpu_torch.models.layers import Int8Kernel
from video_llava_tpu_torch.models.llama import fuse_layer_kernels, layer_layout
from video_llava_tpu_torch.ops.quant import quantize_params
from video_llava_tpu_torch.ops.quant4 import quantize_params_int4

StateDict = Dict[str, torch.Tensor]

# -- state-dict IO ------------------------------------------------------------

# safetensors dtype -> (numpy dtype of the stored bytes, torch dtype)
_ST_DTYPES = {
    "F64": (np.float64, torch.float64), "F32": (np.float32, torch.float32),
    "F16": (np.float16, torch.float16), "BF16": (np.int16, torch.bfloat16),
    "I64": (np.int64, torch.int64), "I32": (np.int32, torch.int32),
    "I16": (np.int16, torch.int16), "I8": (np.int8, torch.int8),
    "U8": (np.uint8, torch.uint8), "BOOL": (np.bool_, torch.bool),
}


def load_safetensors(path: str) -> StateDict:
    """A .safetensors file -> {name: tensor in the file's dtype}, without
    the safetensors package: an 8-byte little-endian header length, the
    JSON header ({name: {dtype, shape, data_offsets}}, offsets relative
    to the end of the header), then the data, memory-mapped copy-on-write
    (pages are read when a tensor is used). BF16 goes through an int16
    view."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    if not header:
        return {}
    data = np.memmap(path, dtype=np.uint8, mode="c", offset=8 + n)
    out: StateDict = {}
    for name, info in header.items():
        if info["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}")
        np_dtype, torch_dtype = _ST_DTYPES[info["dtype"]]
        start, end = info["data_offsets"]
        arr = data[start:end].view(np_dtype).reshape(info["shape"])
        t = torch.from_numpy(arr)
        out[name] = t.view(torch_dtype) if torch_dtype == torch.bfloat16 \
            else t
    return out


_ST_NAMES = {torch_dtype: name
             for name, (_, torch_dtype) in _ST_DTYPES.items()}


def save_safetensors(path: str, tensors) -> None:
    """A .safetensors file written by hand (no safetensors package): the
    8-byte little-endian header length, the JSON header (padded to 8
    bytes), then each tensor's bytes in order. `tensors`: a {name:
    tensor} mapping or [(name, tensor)], copied to the host one at a
    time; every dtype load_safetensors reads."""
    if isinstance(tensors, dict):
        tensors = list(tensors.items())
    header, off = {}, 0
    for name, t in tensors:
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + n]}
        off += n
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for _, t in tensors:
            f.write(t.detach().contiguous().view(torch.uint8).cpu().numpy()
                    .tobytes())


def load_torch_bin(path: str) -> StateDict:
    """A torch .bin state dict, memory-mapped, on the CPU, in its own
    dtypes."""
    return torch.load(path, map_location="cpu", weights_only=True, mmap=True)


def load_torch_checkpoint_file(path: str) -> StateDict:
    """A research-repo .pth/.pt checkpoint: unwraps the common
    {'model': sd} / {'state_dict': sd} / {'module': sd} / {'network': sd}
    nesting (RAM, GroundingDINO and XMem/DEVA training checkpoints) and
    drops entries that are not tensors."""
    obj = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    for key in ("model", "state_dict", "module", "network"):
        if isinstance(obj, dict) and isinstance(obj.get(key), dict):
            obj = obj[key]
            break
    return {k: v for k, v in obj.items() if isinstance(v, torch.Tensor)}


def _load_file(path: str) -> StateDict:
    return (load_safetensors(path) if path.endswith(".safetensors")
            else load_torch_bin(path))


def checkpoint_files(path: str) -> List[str]:
    """The weight files of an HF model directory: the shards an
    index.json names (safetensors first), else the single file."""
    for idx_name in ("model.safetensors.index.json",
                     "pytorch_model.bin.index.json"):
        idx = os.path.join(path, idx_name)
        if os.path.exists(idx):
            with open(idx) as f:
                weight_map = json.load(f)["weight_map"]
            return [os.path.join(path, s)
                    for s in sorted(set(weight_map.values()))]
    for name in ("model.safetensors", "pytorch_model.bin"):
        fp = os.path.join(path, name)
        if os.path.exists(fp):
            return [fp]
    raise FileNotFoundError(f"no checkpoint found under {path}")


def checkpoint_shards(path: str) -> Iterator[StateDict]:
    """The state dict of an HF model directory, one shard at a time, so
    that only one shard is mapped in host memory at a time."""
    for fp in checkpoint_files(path):
        yield _load_file(fp)


def load_checkpoint_dir(path: str) -> StateDict:
    """The whole state dict of an HF model directory (single or sharded
    .bin and .safetensors layouts)."""
    out: StateDict = {}
    for shard in checkpoint_shards(path):
        out.update(shard)
    return out


def _shards(sd: Union[StateDict, Iterable[StateDict]]) -> Iterable[StateDict]:
    return [sd] if isinstance(sd, dict) else sd


# -- helpers ------------------------------------------------------------------


def row_mean(w: torch.Tensor, chunk: int = 4096,
             device=None) -> torch.Tensor:
    """The f32 mean of w's rows on `device` (w's by default), summed in
    f32 over chunks of `chunk` rows, each moved there alone (no f32 or
    device copy of the whole table)."""
    acc = torch.zeros(w.shape[1:], dtype=torch.float32,
                      device=device or w.device)
    for i in range(0, w.shape[0], chunk):
        acc += w[i:i + chunk].to(acc.device).float().sum(0)
    return acc / w.shape[0]


def resize_rows(w: torch.Tensor, new_rows: int,
                dtype: Optional[torch.dtype] = None, device=None,
                transpose: bool = False, chunk: int = 4096) -> torch.Tensor:
    """w (rows, ...) grown (or kept) to new_rows rows, in `dtype` (w's by
    default) on `device` (w's by default): the new rows take w's f32 row
    mean (:func:`row_mean`; the reference's resize and average init),
    cast once. transpose: the result is (cols, new_rows), w's rows as
    columns (an lm_head kernel). w moves `chunk` rows at a time."""
    dtype, device = dtype or w.dtype, device or w.device
    rows = w.shape[0]
    if rows > new_rows:
        raise ValueError(f"cannot shrink vocab {rows} -> {new_rows}")
    out = torch.empty((new_rows,) + tuple(w.shape[1:]), dtype=dtype,
                      device=device)
    if transpose:
        out = out.t()
    for i in range(0, rows, chunk):
        part = w[i:i + chunk].to(device)
        if transpose:
            out[:, i:i + len(part)] = part.t()
        else:
            out[i:i + len(part)] = part
    if new_rows > rows:
        mean = row_mean(w, chunk, device).to(dtype)
        if transpose:
            out[:, rows:] = mean[:, None]
        else:
            out[rows:] = mean
    return out


def _order(key: str):
    """Sort keys so that each layer's tensors come together."""
    m = re.search(r"layers\.(\d+)\.", key)
    return (int(m.group(1)) if m else -1, key)


def _quantizer(llm):
    """The port's quantize_params(_int4) at the module's layout, for one
    layer's (or the embedding's) leaves: min_size 0, as the module
    already decided which leaves are quantized."""
    if llm.quant == "int4":
        return functools.partial(quantize_params_int4, min_size=0,
                                 group_size=llm.group_size)
    return functools.partial(quantize_params, min_size=0)


def _load_tree(params: Dict[str, torch.nn.Parameter], prefix: str,
               tree) -> None:
    for name, t in flatten_tree(tree).items():
        params[prefix + name].copy_(t)


# -- LLaMA --------------------------------------------------------------------

# HF name inside a decoder layer -> the port's linear (kernels transposed)
LLAMA_LINEARS = {
    "self_attn.q_proj.weight": "wq", "self_attn.k_proj.weight": "wk",
    "self_attn.v_proj.weight": "wv", "self_attn.o_proj.weight": "wo",
    "mlp.gate_proj.weight": "gate", "mlp.up_proj.weight": "up",
    "mlp.down_proj.weight": "down",
}
LLAMA_NORMS = {"input_layernorm.weight": "input_norm.scale",
               "post_attention_layernorm.weight": "post_norm.scale"}


@torch.no_grad()
def convert_llama(sd: Union[StateDict, Iterable[StateDict]], llm,
                  prefix: str = "model.") -> None:
    """Write an HF LlamaForCausalLM state dict (a dict, or shards in any
    order) into the port's Llama module `llm`, on its device and in its
    dtype (JAX convert_llama): kernels transposed to (in, out);
    embed_tokens and lm_head grown to cfg.vocab_size with mean-init rows
    (:func:`resize_rows`), lm_head tied to embed_tokens when the
    checkpoint has none. A layer's linears wait on the device until all
    seven have arrived; then, for a quantized module, they are quantized
    with the port's quantize_params(_int4) and fused as the module's
    layout says (llm.quant, llm.group_size, llm.fuse), as
    random_init_quantized_llm_ does, and written. Keys outside the LLM
    (an mm_projector in the directory, rotary inv_freq) are ignored.
    Raises KeyError if a tensor of the module never arrived."""
    cfg = llm.cfg
    scale = llm.final_norm.scale
    dev, dtype = scale.device, scale.dtype
    params = dict(llm.named_parameters())
    quantize = _quantizer(llm) if llm.quant else None
    formats = {n: fmt for n, (_, _, fmt, _) in
               layer_layout(cfg, llm.quant, llm.group_size).items()}
    layer_re = re.compile(re.escape(prefix) + r"layers\.(\d+)\.(.+)$")
    pending: Dict[int, Dict[str, torch.Tensor]] = {}
    done = {"final_norm": False, "layers": set(), "norms": set()}
    embed_src = None

    def write_layer(li: int, kernels: Dict[str, torch.Tensor]) -> None:
        dense = {n: {"kernel": w} for n, w in kernels.items()
                 if not formats[n]}
        quant = {n: {"kernel": w} for n, w in kernels.items()
                 if formats[n]}
        tree = {**dense, **(quantize(quant) if quant else {})}
        if llm.fuse:
            tree = fuse_layer_kernels({"layers": tree})["layers"]
        _load_tree(params, f"layers.{li}.", tree)

    def write_top(name: str, w: torch.Tensor) -> None:
        """embed_tokens (w (rows, d)) or lm_head (w (rows, d), stored
        transposed), grown to the vocab on the device; a quantized leaf
        is built dense there first, as random_init_quantized_llm_ draws
        it, then quantized."""
        head = name == "lm_head"
        leaf = llm.lm_head.kernel if head else llm.embed_tokens.weight
        dense = isinstance(leaf, torch.Tensor)
        if dense and not head:  # in place: no second table on the device
            rows = w.shape[0]
            if rows > cfg.vocab_size:
                raise ValueError(f"cannot shrink vocab {rows} -> "
                                 f"{cfg.vocab_size}")
            leaf[:rows].copy_(w)
            if cfg.vocab_size > rows:
                leaf[rows:] = row_mean(w, device=dev).to(dtype)
            return
        full = resize_rows(w, cfg.vocab_size, dtype, dev, transpose=head)
        if dense:
            leaf.copy_(full)
            return
        key = "kernel" if head else "weight"
        _load_tree(params, "", quantize({name: {key: full}}))

    head_done = False
    for shard in _shards(sd):
        for key in sorted(shard, key=_order):
            t = shard[key]
            if key == prefix + "embed_tokens.weight":
                embed_src = t
                write_top("embed_tokens", t)
                continue
            if key == "lm_head.weight":
                write_top("lm_head", t)
                head_done = True
                continue
            if key == prefix + "norm.weight":
                params["final_norm.scale"].copy_(t)
                done["final_norm"] = True
                continue
            m = layer_re.match(key)
            if m is None or int(m.group(1)) >= cfg.num_layers:
                continue
            li, rest = int(m.group(1)), m.group(2)
            if rest in LLAMA_NORMS:
                params[f"layers.{li}.{LLAMA_NORMS[rest]}"].copy_(t)
                done["norms"].add((li, rest))
            elif rest in LLAMA_LINEARS:
                layer = pending.setdefault(li, {})
                layer[LLAMA_LINEARS[rest]] = t.to(dev, dtype).t().contiguous()
                if len(layer) == len(LLAMA_LINEARS):
                    write_layer(li, pending.pop(li))
                    done["layers"].add(li)
    if embed_src is not None and not head_done:
        write_top("lm_head", embed_src)
        head_done = True
    missing = [f"{prefix}layers.{li}.{hf}" for li in range(cfg.num_layers)
               for hf, ours in LLAMA_LINEARS.items()
               if li not in done["layers"]
               and ours not in pending.get(li, {})]
    missing += [f"{prefix}layers.{li}.{hf}" for li in range(cfg.num_layers)
                for hf in LLAMA_NORMS if (li, hf) not in done["norms"]]
    if embed_src is None:
        missing.append(prefix + "embed_tokens.weight")
    if not done["final_norm"]:
        missing.append(prefix + "norm.weight")
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} LLaMA tensors, "
                       f"first {missing[:8]}")


# -- CLIP vision --------------------------------------------------------------

CLIP_LAYER = {
    "layer_norm1.weight": "ln1.scale", "layer_norm1.bias": "ln1.bias",
    "layer_norm2.weight": "ln2.scale", "layer_norm2.bias": "ln2.bias",
    "self_attn.q_proj.weight": "q.kernel", "self_attn.q_proj.bias": "q.bias",
    "self_attn.k_proj.weight": "k.kernel", "self_attn.k_proj.bias": "k.bias",
    "self_attn.v_proj.weight": "v.kernel", "self_attn.v_proj.bias": "v.bias",
    "self_attn.out_proj.weight": "o.kernel",
    "self_attn.out_proj.bias": "o.bias",
    "mlp.fc1.weight": "fc1.kernel", "mlp.fc1.bias": "fc1.bias",
    "mlp.fc2.weight": "fc2.kernel", "mlp.fc2.bias": "fc2.bias",
}


def _clip_name(rest: str, top: Dict[str, str]) -> Optional[str]:
    """An HF CLIP tower name (prefix removed) -> the port's name."""
    if rest in top:
        return top[rest]
    m = re.match(r"encoder\.layers\.(\d+)\.(.+)$", rest)
    if m and m.group(2) in CLIP_LAYER:
        return f"layers.{m.group(1)}.{CLIP_LAYER[m.group(2)]}"
    return None


def _clip_value(name: str, t: torch.Tensor, hidden: int) -> torch.Tensor:
    """torch Linear (out, in) -> (in, out); the stride-P conv (hidden, 3,
    P, P) -> the patchify matmul's (P*P*3, hidden) in (ph, pw, c) order."""
    if name == "patch_embedding":
        return t.permute(2, 3, 1, 0).reshape(-1, hidden)
    return t.t() if name.endswith(".kernel") else t


CLIP_VISION_TOP = {
    "embeddings.class_embedding": "class_embedding",
    "embeddings.patch_embedding.weight": "patch_embedding",
    "embeddings.position_embedding.weight": "position_embedding",
    # HF's (sic) attribute name is pre_layrnorm
    "pre_layrnorm.weight": "pre_layernorm.scale",
    "pre_layrnorm.bias": "pre_layernorm.bias",
    "post_layernorm.weight": "post_layernorm.scale",
    "post_layernorm.bias": "post_layernorm.bias",
}


@torch.no_grad()
def convert_clip_vision(sd: Union[StateDict, Iterable[StateDict]], tower,
                        prefix: str = "vision_model.") -> None:
    """Write an HF CLIPVisionModel (or CLIPModel) state dict into the
    port's CLIPVisionTower `tower`, tensor by tensor on its device and in
    its dtype (JAX convert_clip_vision). The text tower's keys and
    position_ids are ignored. Raises KeyError if a tensor of the tower
    never arrived."""
    params = dict(tower.named_parameters())
    hidden = tower.cfg.hidden_size
    dev = tower.class_embedding.device
    seen = set()
    for shard in _shards(sd):
        for key, t in shard.items():
            if not key.startswith(prefix):
                continue
            name = _clip_name(key[len(prefix):], CLIP_VISION_TOP)
            if name is None or name not in params:
                continue
            params[name].copy_(_clip_value(name, t.to(dev), hidden))
            seen.add(name)
    missing = sorted(set(params) - seen)
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} CLIP vision "
                       f"tensors, first {missing[:8]}")


# -- CLIP text ----------------------------------------------------------------


def convert_clip_text(sd: StateDict, cfg, device=None,
                      dtype: torch.dtype = torch.float32,
                      prefix: str = "text_model.") -> dict:
    """HF CLIPTextModel (or CLIPModel) state dict -> the text tower's
    parameter tree, tensors on `device` in `dtype`: the JAX package's
    convert_clip_text tree with its stacked layers as a list (the port's
    nested-dict trees, as the grounding models keep them), kernels (in,
    out). The identity text projection when the checkpoint has none.
    models/clip.text_forward runs it (the grounding crop filter's
    zero-shot class embeddings)."""
    def g(key):
        return sd[prefix + key].to(device=device, dtype=dtype)

    def lin(key, bias=True):
        p = {"kernel": g(key + ".weight").t().contiguous()}
        if bias:
            p["bias"] = g(key + ".bias")
        return p

    def ln(key):
        return {"scale": g(key + ".weight"), "bias": g(key + ".bias")}

    layers = []
    for i in range(cfg.num_layers):
        lp = f"encoder.layers.{i}."
        layers.append({
            "ln1": ln(lp + "layer_norm1"),
            "q": lin(lp + "self_attn.q_proj"),
            "k": lin(lp + "self_attn.k_proj"),
            "v": lin(lp + "self_attn.v_proj"),
            "o": lin(lp + "self_attn.out_proj"),
            "ln2": ln(lp + "layer_norm2"),
            "fc1": lin(lp + "mlp.fc1"),
            "fc2": lin(lp + "mlp.fc2"),
        })
    if "text_projection.weight" in sd:
        proj = sd["text_projection.weight"].to(device=device, dtype=dtype)
        proj = proj.t().contiguous()
    else:
        proj = torch.eye(cfg.hidden_size, cfg.projection_dim, device=device,
                         dtype=dtype)
    return {
        "token_embedding": {"weight": g("embeddings.token_embedding.weight")},
        "position_embedding": g("embeddings.position_embedding.weight"),
        "final_layernorm": ln("final_layer_norm"),
        "text_projection": {"kernel": proj},
        "layers": layers,
    }


# -- projector ----------------------------------------------------------------


def projector_weights(sd: StateDict) -> Dict[str, torch.Tensor]:
    """mm_projector weights of a reference-style checkpoint -> the port's
    Projector names: single-linear keys ('...mm_projector.weight' /
    'bias') or the mlpNx Sequential's ('...mm_projector.{0,2,4}.weight',
    the Linears at the even indices), kernels (in, out). Raises KeyError
    when the state dict has no mm_projector keys."""
    proj = {k.split("mm_projector.")[1]: v for k, v in sd.items()
            if "mm_projector." in k}
    if not proj:
        raise KeyError("no mm_projector keys in state dict")
    if "weight" in proj:
        idxs = [None]
    else:
        idxs = sorted({int(m.group(1)) for k in proj
                       for m in [re.match(r"^(\d+)\.", k)] if m})
    out = {}
    for j, i in enumerate(idxs):
        pre = "" if i is None else f"{i}."
        out[f"layers.{j}.kernel"] = proj[pre + "weight"].t()
        out[f"layers.{j}.bias"] = proj[pre + "bias"]
    return out


@torch.no_grad()
def convert_projector(sd: StateDict, projector) -> None:
    """Write a checkpoint's mm_projector into the port's Projector, on its
    device and in its dtype (JAX convert_projector)."""
    params = dict(projector.named_parameters())
    weights = projector_weights(sd)
    if set(weights) != set(params):
        raise KeyError(f"mm_projector keys {sorted(weights)} do not match "
                       f"the projector's {sorted(params)}")
    for name, t in weights.items():
        params[name].copy_(t)


OVERLAY_KNOWN = ("mm_projector.", "embed_tokens.weight", "embed_in")


@torch.no_grad()
def apply_projector_overlay(model, sd: StateDict) -> Dict[str, list]:
    """Non-strict overlay of a reference mm_projector checkpoint onto a
    VideoLLaVA, in place (model_utils.py:119-127, JAX
    apply_projector_overlay): the projector's weights and, if present,
    the token embeddings (resized to the model's vocab with mean-init
    rows) are replaced; everything else stays. An embedding that the
    model holds quantized (int8 rows) takes the checkpoint's rows
    quantized into that format (the JAX overlay raises there: it reads
    .shape of the quantized dict). Returns {'applied': [...],
    'unexpected': [...]}, as the JAX package's report."""
    report = {"applied": [], "unexpected": []}
    try:
        convert_projector(sd, model.projector)
        report["applied"].append("mm_projector")
    except KeyError:
        pass
    embed_key = next((k for k in sd if k.endswith("embed_tokens.weight")),
                     None)
    if embed_key is not None:
        llm = model.llm
        leaf = llm.embed_tokens.weight
        vocab = llm.cfg.vocab_size
        if isinstance(leaf, Int8Kernel):
            dev = leaf.qvalues.device
            dtype = llm.final_norm.scale.dtype
            w = resize_rows(sd[embed_key], vocab, dtype, dev)
            tree = _quantizer(llm)({"embed_tokens": {"weight": w}})
            _load_tree(dict(llm.named_parameters()), "", tree)
        else:
            leaf.copy_(resize_rows(sd[embed_key], vocab, leaf.dtype,
                                   leaf.device))
        report["applied"].append("embed_tokens")
    report["unexpected"] = [k for k in sd
                            if not any(s in k for s in OVERLAY_KNOWN)]
    return report
