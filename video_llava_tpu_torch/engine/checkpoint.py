"""Checkpoints: the whole train state under checkpoint-{step}, resume from
the newest, and the reference's projector-only export.

Counterpart of video_llava_tpu/engine/checkpoint.py, with torch.save in
place of Orbax: ``checkpoint-{step}/state.pt`` holds the model's state
dict (the frozen LLM included, as Orbax's does), the optimizer state of
the trainable parameters and the step. Re-saving a step replaces it (as
Orbax's force=True). ``export_projector`` writes the keys the reference's
trainer keeps (``model.mm_projector.*`` and ``model.embed_tokens.weight``,
f32) to a torch .bin that the JAX package's export also writes. Under a
mesh (sharded training) every rank calls these: the state is gathered to
the first rank, which alone writes the one-process format, and a restore
slices each rank's part out of it, so a checkpoint moves between layouts.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Optional

import torch
import torch.distributed as dist

from video_llava_tpu_torch.parallel.sharding import (
    gather_to_first,
    local_slice,
)

STATE_FILE = "state.pt"


def _sharded(model) -> bool:
    mesh = getattr(model, "mesh", None)
    return mesh is not None and mesh.world > 1


def _first_rank() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def _whole_state(state):
    """(params, opt_state) of `state` whole: as they are on one process;
    under a mesh gathered to the first rank (None on the others)."""
    model = state.model
    if not _sharded(model):
        return model.state_dict(), state.opt_state
    params = {n: gather_to_first(t, n, model)
              for n, t in model.state_dict().items()}
    opt = {"count": state.opt_state["count"],
           **{m: {n: gather_to_first(t, n, model)
                  for n, t in state.opt_state[m].items()}
              for m in ("mu", "nu")}}
    return (params, opt) if _first_rank() else (None, None)


def save_checkpoint(ckpt_dir: str, step: int, state) -> str:
    """Write `state` (a train_step.TrainState) under
    {ckpt_dir}/checkpoint-{step}, replacing one of the same step. The
    directory appears whole or not at all (written beside it, then
    renamed). A sharded state is gathered to the first rank, which
    alone writes, in the one-process format (every rank calls this; it
    returns once the file is written)."""
    path = os.path.abspath(os.path.join(ckpt_dir, f"checkpoint-{step}"))
    params, opt = _whole_state(state)
    if _first_rank():
        tmp = f"{path}.tmp{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save({"params": params, "opt_state": opt, "step": int(step)},
                   os.path.join(tmp, STATE_FILE))
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
    if _sharded(state.model):
        dist.barrier()
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The newest checkpoint-* directory, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    best, best_step = None, -1
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"checkpoint-(\d+)", name)
        if m and int(m.group(1)) > best_step:
            best, best_step = os.path.join(ckpt_dir, name), int(m.group(1))
    return best


def restore_checkpoint(path: str, state):
    """Load the checkpoint at `path` (the one-process format, written
    from any mesh) into `state` (its model's parameters in place, each
    rank's part of them under a mesh; the optimizer state on the
    parameters' device, sliced the same way) and return the restored
    TrainState."""
    saved = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                       weights_only=True, mmap=True)
    model = state.model
    if _sharded(model):
        with torch.no_grad():
            for name, t in model.state_dict(keep_vars=True).items():
                t.copy_(local_slice(saved["params"][name], name, model))
    else:
        model.load_state_dict(saved["params"])
    params = dict(model.named_parameters())
    opt = saved["opt_state"]
    if set(opt["mu"]) != set(state.opt_state["mu"]):
        raise ValueError(f"{path}: trainable set {sorted(opt['mu'])} != "
                         f"{sorted(state.opt_state['mu'])}")
    opt_state = {"count": int(opt["count"]),
                 **{m: {n: local_slice(t, n, model).to(params[n].device)
                        for n, t in opt[m].items()}
                    for m in ("mu", "nu")}}
    return type(state)(model, opt_state, int(saved["step"]))


def export_projector(model, out_path: str,
                     include_embeddings: bool = True) -> None:
    """Write the reference-compatible projector checkpoint: a torch .bin
    of 'model.mm_projector.{weight,bias}' (one linear) or
    'model.mm_projector.{2i}.{weight,bias}' (an MLP), weights (out, in),
    plus 'model.embed_tokens.weight', all f32 on the CPU. Under a mesh
    every rank calls it: embed_tokens is gathered whole to the first
    rank, which alone writes."""

    def f32(t):
        return t.detach().float().cpu().contiguous()

    embed = None
    if include_embeddings:
        embed = model.llm.embed_tokens.weight
        if _sharded(model):
            embed = gather_to_first(embed, "llm.embed_tokens.weight", model)
    if not _first_rank():
        return
    sd = {}
    layers = list(model.projector.layers)
    if len(layers) == 1:
        sd["model.mm_projector.weight"] = f32(layers[0].kernel.t())
        sd["model.mm_projector.bias"] = f32(layers[0].bias)
    else:
        for i, layer in enumerate(layers):
            sd[f"model.mm_projector.{2 * i}.weight"] = f32(layer.kernel.t())
            sd[f"model.mm_projector.{2 * i}.bias"] = f32(layer.bias)
    if include_embeddings:
        sd["model.embed_tokens.weight"] = f32(embed)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    torch.save(sd, out_path)
