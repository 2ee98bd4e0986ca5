"""Parameter and cache partition specs (Megatron-style tensor parallel),
applied to the port's modules.

Counterpart of video_llava_tpu/parallel/sharding.py. The rule tables,
the quantized-leaf and stacked-layer cases and the fall-back to
replication are the JAX package's, kept as this package's own copy, so
held against the same parameter tree the two packages place every leaf
the same way (tests/test_torch_sharding_specs.py). A spec is a tuple
with one mesh axis name or None a dimension, as a PartitionSpec is.

Where the JAX package hands the specs to GSPMD, :func:`shard_params`
here slices each parameter of a module to this rank's part of its spec
(the whole tensor where it replicates) and marks each linear and
embedding with the mesh and its layout, which is what the models'
forwards read to place their collectives:

  * ``tp = "out"``: output columns sharded (q/k/v, gate/up, fc1,
    lm_head): the product is local, the heads or the FFN width this
    rank owns;
  * ``tp = "in"``: contraction rows sharded (wo, down, o, fc2): the
    product is partial and summed over 'model', then the bias is added;
  * ``tp = None`` and a local input (int4 wo/down, whose packed bytes
    pair rows i and i + D/2 and so replicate): the input is gathered
    over 'model' and the whole product runs on every rank, as GSPMD
    does for that layout;
  * an embedding with ``tp = "rows"``: the rows of this rank's vocab
    range are looked up, the others masked, then summed over 'model';
  * a module with ``fsdp`` {leaf: dim}: that leaf's 'data' shards are
    gathered along dim at use (models/layers.use_param), the gradient
    summed over 'data' and sliced in the backward pass.

With grad enabled the collectives are parallel/collectives' autograd
Functions. :func:`gather_to_first` and :func:`local_slice` move a
sharded leaf to and from its whole form (checkpoints).

The KV caches are allocated at the local head count (the attention
layers' local configuration), so :func:`shard_kv_cache` only checks.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional, Tuple

import torch

from video_llava_tpu_torch.parallel.mesh import AXES

# (regex on '/'-joined path, spec for the *parameter itself* without the
# stacked-layer axis)
_LLAMA_RULES = [
    (r"embed_tokens/weight$", ("model", None)),
    (r"lm_head/kernel$", (None, "model")),
    (r"w[qkv]/kernel$", (None, "model")),
    (r"wo/kernel$", ("model", None)),
    (r"(gate|up)/kernel$", (None, "model")),
    (r"down/kernel$", ("model", None)),
    (r"(input_norm|post_norm|final_norm)/scale$", (None,)),
]

_CLIP_RULES = [
    (r"(^|/)o/kernel$", ("model", None)),
    (r"(^|/)[qkv]/kernel$", (None, "model")),
    (r"fc1/kernel$", (None, "model")),
    (r"fc2/kernel$", ("model", None)),
    (r"(^|/)[qkv]/bias$", ("model",)),
    (r"fc1/bias$", ("model",)),
]

# Matched, as in the JAX package, against paths relative to the
# projector's own subtree ('layers/0/kernel'), which never contain
# 'projector/': the projector replicates in both packages.
_PROJECTOR_RULES = [
    (r"projector/.*kernel$", (None, "model")),
    (r"projector/.*bias$", ("model",)),
]

_QUANT_LEAVES = ("qvalues", "qvalues_a8", "qvalues_packed", "scales")

Spec = Tuple[Optional[str], ...]


def _spec_for_path(path: str, shape, rules, fsdp: bool) -> Spec:
    ndim = len(shape)
    # Quantized kernels replace the 'kernel' leaf with a dict: match the
    # rules against the PARENT path and adapt the spec to the quantized
    # layout.
    leaf = path.rsplit("/", 1)[-1]
    is_quant = leaf in _QUANT_LEAVES
    match_path = path.rsplit("/", 1)[0] if is_quant else path
    axes = None
    for pat, spec in rules:
        if re.search(pat, match_path):
            axes = list(spec)
            break
    if axes is None:
        return ()
    # Stacked layer params carry a leading num_layers axis.
    if "/layers/" in path or path.startswith("layers/"):
        axes = [None] + axes
    if len(axes) != ndim:
        # bias/norm matched against a differently-shaped leaf: replicate.
        return ()
    if is_quant and axes[-2] is not None:
        # Contraction-sharded kernel (wo/down): int4 nibble packing pairs
        # rows i and i+D/2 in one byte, and int4 group scales span fixed
        # contraction groups; int8 qvalues shard fine, everything else
        # replicates.
        if leaf == "qvalues_packed" or (leaf == "scales" and shape[-2] > 1):
            return ()
    if fsdp and ndim >= 2 and not is_quant:
        # Shard an unsharded axis on 'data' (ZeRO-3).
        free = [i for i, a in enumerate(axes) if a is None]
        if free:
            axes[free[-1]] = "data"
    # Degenerate (size-1) dims cannot shard.
    axes = [a if (a is None or shape[i] > 1) else None
            for i, a in enumerate(axes)]
    if all(a is None for a in axes):
        return ()
    return tuple(axes)


def _specs_for_tree(params, rules, fsdp: bool, path: str = ""):
    """The spec of every leaf of a nested dict / list tree (the JAX
    package's layout: stacked layers), keyed as the tree is."""
    if isinstance(params, dict):
        return {k: _specs_for_tree(v, rules, fsdp,
                                   f"{path}/{k}" if path else str(k))
                for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [_specs_for_tree(v, rules, fsdp,
                                f"{path}/{i}" if path else str(i))
                for i, v in enumerate(params)]
    return _spec_for_path(path, tuple(params.shape), rules, fsdp)


def llama_param_specs(params, fsdp: bool = False):
    return _specs_for_tree(params, _LLAMA_RULES, fsdp)


def clip_param_specs(params, fsdp: bool = False):
    return _specs_for_tree(params, _CLIP_RULES, fsdp)


def videollava_param_specs(params, fsdp: bool = False):
    """Specs for the full {vision, projector, llm} tree."""
    return {
        "vision": clip_param_specs(params["vision"], fsdp),
        "projector": _specs_for_tree(params["projector"], _PROJECTOR_RULES,
                                     fsdp),
        "llm": llama_param_specs(params["llm"], fsdp),
    }


def cache_spec() -> Spec:
    """KV cache (L, b, len, h_kv, hd): batch on 'data', heads on 'model'."""
    return (None, "data", None, "model", None)


def cache_scale_spec() -> Spec:
    """int8 KV-cache scales (L, b, len, h_kv)."""
    return (None, "data", None, "model")


def paged_cache_spec() -> Spec:
    """Paged KV block pool (L, NB, BS, h_kv, hd): block ids are global,
    so the pool shards heads only."""
    return (None, None, None, "model", None)


def paged_cache_scale_spec() -> Spec:
    """int8 paged-pool scales (L, NB, BS, h_kv)."""
    return (None, None, None, "model")


def batch_spec(ndim: int) -> Spec:
    return tuple(["data"] + [None] * (ndim - 1))


def divisible_spec(spec: Spec, shape, mesh) -> Spec:
    """Drop mesh axes from dims they don't evenly divide (a 32006 vocab
    on a 4-way 'model' axis): the dim falls back to replicated rather
    than erroring (models.llama.pad_vocab avoids it)."""
    axes = list(spec) + [None] * (len(shape) - len(spec))
    for i, a in enumerate(axes):
        if a is None:
            continue
        names = (a,) if isinstance(a, str) else tuple(a)
        size = 1
        for n in names:
            size *= mesh.shape[n]
        if shape[i] % size:
            axes[i] = None
    while axes and axes[-1] is None:
        axes.pop()
    return tuple(axes)


# -- the port's modules -------------------------------------------------------


def _tree_path(name: str) -> Tuple[str, str, bool]:
    """A VideoLLaVA parameter name ('llm.layers.3.wq.kernel.scales') ->
    (section, the JAX tree's path within it with the layer index
    dropped ('layers/wq/kernel/scales'), whether the JAX tree stacks
    the leaf along a leading layer axis). The projector's layers are a
    list in both packages and keep their index."""
    section, *rest = name.split(".")
    stacked = (section in ("vision", "llm") and len(rest) > 1
               and rest[0] == "layers" and rest[1].isdigit())
    if stacked:
        rest = rest[:1] + rest[2:]
    return section, "/".join(rest), stacked


_RULES = {"vision": _CLIP_RULES, "projector": _PROJECTOR_RULES,
          "llm": _LLAMA_RULES}


def module_param_specs(model, fsdp: bool = False) -> Dict[str, Spec]:
    """{parameter name: spec of that parameter} of a VideoLLaVA module,
    each the spec the JAX package gives its leaf in the stacked tree,
    without the layer axis."""
    specs = {}
    for name, p in model.named_parameters():
        section, path, stacked = _tree_path(name)
        shape = ((1,) if stacked else ()) + tuple(p.shape)
        spec = _spec_for_path(path, shape, _RULES[section], fsdp)
        if stacked and spec:
            spec = spec[1:]
        specs[name] = spec
    return specs


def _main_leaf(kernel) -> torch.Tensor:
    """The leaf whose layout a (possibly quantized) kernel follows."""
    if isinstance(kernel, torch.Tensor):
        return kernel
    for leaf in ("qvalues_packed", "qvalues", "qvalues_a8"):
        if hasattr(kernel, leaf):
            return getattr(kernel, leaf)
    raise TypeError(f"kernel {type(kernel).__name__}")


def _local_slice(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's part of `t` under `spec`: each sharded dimension cut
    at the rank's coordinate along its axis. A column-major 2-D tensor
    (a W8A8 kernel's qvalues_a8) stays column-major."""
    col_major = t.dim() == 2 and t.stride(0) == 1 and t.stride(1) != 1
    for dim, axis in enumerate(spec):
        if axis is None or mesh.shape[axis] == 1:
            continue
        n = t.shape[dim] // mesh.shape[axis]
        t = t.narrow(dim, mesh.coords[axis] * n, n)
    return t.t().contiguous().t() if col_major else t.contiguous()


def local_slice(t: torch.Tensor, name: str, model) -> torch.Tensor:
    """This rank's part of a whole tensor `t` of parameter `name` of a
    sharded `model` (a restored checkpoint's), `t` itself where the
    model is not sharded."""
    spec = getattr(model, "param_specs", {}).get(name)
    return _local_slice(t, spec, model.mesh) if spec else t


def sharded_axes(spec: Spec, mesh) -> Tuple[str, ...]:
    """The mesh axes (of more than one rank) that `spec` shards."""
    return tuple(a for a in AXES if a in (spec or ())
                 and mesh.shape[a] > 1)


def gather_to_first(t: torch.Tensor, name: str, model):
    """The whole tensor of parameter (or optimizer leaf) `name` of a
    sharded `model`, from this rank's part `t`: on the mesh's first rank
    a CPU tensor, None on the others. Collective: every rank calls it
    with its part. Only the ranks holding distinct shards send theirs
    (data row 0 for a 'model'-sharded leaf, model column 0 for a
    'data'-sharded one, every rank for both), through a gather of CPU
    tensors to the first rank, as Orbax writes a global array from its
    shards."""
    import torch.distributed as dist

    mesh = model.mesh
    spec = getattr(model, "param_specs", {}).get(name, ())
    axes = sharded_axes(spec, mesh)
    first = dist.get_rank() == 0 if dist.is_initialized() else True
    local = t.detach().to("cpu", copy=True).contiguous()  # a snapshot
    if not axes:
        return local if first else None
    if axes == ("model",):
        if mesh.coords["data"]:
            return None
        group, coords = mesh.groups["model"], [
            {"data": 0, "model": j} for j in range(mesh.shape["model"])]
    elif axes == ("data",):
        if mesh.coords["model"]:
            return None
        group, coords = mesh.groups["data"], [
            {"data": i, "model": 0} for i in range(mesh.shape["data"])]
    else:
        group, coords = None, [
            {"data": r // mesh.shape["model"],
             "model": r % mesh.shape["model"]} for r in range(mesh.world)]
    parts = [torch.empty_like(local) for _ in coords] if first else None
    dist.gather(local, parts, dst=0, group=group)
    if not first:
        return None
    shape = list(local.shape)
    for dim, axis in enumerate(spec):
        if axis in axes:
            shape[dim] *= mesh.shape[axis]
    full = local.new_empty(shape)
    for part, at in zip(parts, coords):
        view = full
        for dim, axis in enumerate(spec):
            if axis in axes:
                n = local.shape[dim]
                view = view.narrow(dim, at[axis] * n, n)
        view.copy_(part)
    return full


@torch.no_grad()
def shard_params(model, mesh, specs: Optional[Dict[str, Spec]] = None,
                 fsdp: bool = False):
    """Keep this rank's part of every parameter of `model` (a
    VideoLLaVA), in place: each spec (module_param_specs(model, fsdp)
    by default) made divisible (divisible_spec) and the tensor sliced
    along its sharded dims, whole where it replicates. Every Linear and
    Embedding then learns its 'model' layout (module docstring), every
    module holding an FSDP leaf (a 'data' dim: the free dim of the big
    matched kernels, the LLM's layer norms) the dim to gather it along
    at use (its `fsdp`), and the LLM and CLIP layers their local head
    counts and FFN width. The local specs are kept as
    `model.param_specs`. Parameters come back frozen: set the trainable
    ones afterwards (train_step.trainable_mask). Returns `model`. Raises
    on the fused wqkv / gate_up layout (the rules do not cover wqkv, and
    a contiguous split of gate_up would hand one rank all of gate), and
    where a local width breaks a head or an int4 kernel's 128-column
    tile."""
    from video_llava_tpu_torch.models.layers import Embedding, Linear

    if getattr(model.llm, "fuse", False) or any(
            hasattr(layer, n) for layer in model.llm.layers
            for n in ("wqkv", "gate_up")):
        raise ValueError("shard_params: the fused wqkv / gate_up layout "
                         "does not shard; build the model with "
                         "llm_fuse=False under a mesh")
    specs = dict(specs or module_param_specs(model, fsdp))
    if mesh.world == 1:
        return model
    local = {}
    for name, p in model.named_parameters():
        spec = divisible_spec(specs[name], p.shape, mesh)
        local[name] = spec
        mod_name, leaf = name.rsplit(".", 1)
        mod = model.get_submodule(mod_name)
        if sharded_axes(spec, mesh):
            setattr(mod, leaf, torch.nn.Parameter(
                _local_slice(p.data, spec, mesh), requires_grad=False))
        if "data" in sharded_axes(spec, mesh):
            mod.fsdp = dict(getattr(mod, "fsdp", None) or {},
                            **{leaf: spec.index("data")})
            mod.mesh = mesh
    for name, mod in model.named_modules():
        if isinstance(mod, Linear):
            kernel = mod.kernel
            key = f"{name}.kernel" + (
                "" if isinstance(kernel, torch.Tensor) else
                "." + next(n for n in ("qvalues_packed", "qvalues",
                                       "qvalues_a8") if hasattr(kernel, n)))
            spec = local[key] + (None,) * (2 - len(local[key]))
            mod.tp = ("out" if spec[-1] == "model" else
                      "in" if spec[-2] == "model" else None)
            mod.mesh = mesh
        elif isinstance(mod, Embedding):
            w = mod.weight
            key = f"{name}.weight" + ("" if isinstance(w, torch.Tensor)
                                      else ".qvalues")
            mod.tp = "rows" if local[key][:1] == ("model",) else None
            mod.mesh = mesh
    _localize_llm(model.llm, mesh)
    _localize_clip(model.vision, mesh)
    model.mesh = mesh
    model.param_specs = local
    return model


def _local_width(lin) -> int:
    leaf = _main_leaf(lin.kernel)
    return leaf.shape[-1]


def _check_int4_tile(lin, name: str) -> None:
    k = lin.kernel
    if hasattr(k, "qvalues_packed") and k.qvalues_packed.shape[-1] % 128:
        raise ValueError(
            f"{name}: the local int4 width {k.qvalues_packed.shape[-1]} is "
            "not a multiple of the W4A8 kernels' 128-column tile; take a "
            "'model' axis that keeps it one")


def _localize_llm(llm, mesh) -> None:
    cfg = llm.cfg
    hd = cfg.head_dim
    layer = llm.layers[0]
    wq, wk, gate = _local_width(layer.wq), _local_width(layer.wk), \
        _local_width(layer.gate)
    for name, w in (("wq", wq), ("wk", wk)):
        if w % hd:
            raise ValueError(f"llm {name}: a local width of {w} columns "
                             f"splits a head of {hd}")
    local = dataclasses.replace(cfg, num_heads=wq // hd,
                                num_kv_heads=wk // hd,
                                intermediate_size=gate)
    _check_int4_tile(llm.lm_head, "llm.lm_head")
    for i, lyr in enumerate(llm.layers):
        lyr.cfg = local
        for n in ("wq", "wk", "wv", "gate", "up"):
            _check_int4_tile(getattr(lyr, n), f"llm.layers.{i}.{n}")
    llm.full_cfg = cfg
    llm.cfg = local
    llm.mesh = mesh


def _localize_clip(vision, mesh) -> None:
    hd = vision.cfg.hidden_size // vision.cfg.num_heads
    for i, lyr in enumerate(vision.layers):
        w = _local_width(lyr.q)
        if w % hd:
            raise ValueError(f"vision.layers.{i}.q: a local width of {w} "
                             f"columns splits a head of {hd}")
        lyr.num_heads = w // hd
    vision.mesh = mesh


def _check_cache_heads(cache, llm) -> None:
    h = llm.cfg.num_kv_heads
    if cache.k.shape[3] != h:
        raise ValueError(f"cache of {cache.k.shape[3]} KV heads; this "
                         f"rank's layers hold {h}")


def shard_kv_cache(cache, llm):
    """A cache (KVCache or PagedKVCache) in this rank's layout: k/v and
    the int8 scales hold the local KV heads (the heads of
    cache_spec / paged_cache_spec on 'model'), lengths and block tables
    are whole on every rank. Caches are created at the local head count
    from the LLM's local configuration, so this checks that and returns
    the cache."""
    _check_cache_heads(cache, llm)
    return cache


constrain_kv_cache = shard_kv_cache
