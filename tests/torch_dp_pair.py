"""Shared pieces of the data-parallel and FSDP tests
(tests/test_torch_dp_*.py, test_torch_fsdp_train_step.py,
test_torch_pool_sharded.py): the tiny training configuration of
tests/torch_train_pair.py in the port's config classes, and the workers
that the gloo ranks of tests/torch_tp_pair.run_ranks run. The spawned
ranks import this module, so it imports no JAX: numpy trees and plain
values cross into them, and rank 0's result comes back."""

import dataclasses

import numpy as np
import torch

from video_llava_tpu_torch.config import LlamaConfig, VideoLLaVAConfig
from video_llava_tpu_torch.runtime.tokenizer import ByteTokenizer


def train_cfg(num_layers: int = 2, width: int = 64) -> VideoLLaVAConfig:
    """tests/torch_train_pair.tiny_cfg (vocab 512, width 64, 4 heads of
    16, 8 temporal tokens, the byte tokenizer's video ids) in the port's
    classes; another `width` keeps 4 heads and an FFN of twice it."""
    tok = ByteTokenizer()
    return dataclasses.replace(
        VideoLLaVAConfig.tiny(),
        llm=dataclasses.replace(
            LlamaConfig.tiny(vocab_size=512), num_layers=num_layers,
            hidden_size=width, intermediate_size=2 * width, num_heads=4,
            num_kv_heads=4, head_dim=width // 4),
        max_temporal_tokens=8,
        vid_patch_token_id=tok.vid_patch_token_id,
        vid_start_token_id=tok.vid_start_token_id,
        vid_end_token_id=tok.vid_end_token_id,
    )


def local_rows(batch: dict, mesh) -> dict:
    """The rows of `batch` (numpy) at this rank's 'data' coordinate, as
    tensors."""
    d, n = mesh.coords["data"], mesh.shape["data"]
    b = len(batch["input_ids"]) // n
    return {k: torch.from_numpy(np.ascontiguousarray(v[d * b:(d + 1) * b]))
            for k, v in batch.items()}


# -- workers --------------------------------------------------------------


def grid_worker(rank, world, data, model):
    """make_mesh(data, model): this rank's coordinates and axis ranks,
    and each axis group's sum of the ranks' global ranks, from every
    rank."""
    from video_llava_tpu_torch.parallel import multihost
    from video_llava_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(data, model)
    sums = {a: float(mesh.all_sum(torch.tensor([float(rank)]), a)[0])
            for a in ("data", "model")}
    return multihost.all_gather_objects(
        {"rank": rank, "coords": dict(mesh.coords),
         "axis_ranks": {a: list(r) for a, r in mesh.axis_ranks.items()},
         "sums": sums})


def collectives_worker(rank, world, x, w_col, w_row, w_fsdp, xs, c):
    """Each autograd collective of parallel/collectives.py on a (2, 2)
    mesh, the gradients of a scalar loss -> every rank's gradients:

      * copy_to then a column-sharded product, gathered: loss
        sum(c * gather(copy_to(x) @ w_col[:, cols])), grads of x and of
        this rank's columns;
      * a row-sharded product summed by reduce_from: loss sum(c[:, :w] *
        reduce_from(x[:, rows] @ w_row[rows])), grads of this rank's
        x columns and w_row rows;
      * an FSDP parameter gathered over 'data': this data rank's rows
        xs[d] of a batch, loss sum((xs[d] @ gather_param(w_fsdp
        rows)) ** 2) on each rank, the grad of this rank's shard of
        w_fsdp (the sum over the data ranks' losses sliced)."""
    from video_llava_tpu_torch.parallel import collectives, multihost
    from video_llava_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(2, 2)
    d, m = mesh.coords["data"], mesh.coords["model"]
    out = {"rank": rank, "coords": (d, m)}

    xt = torch.tensor(x, requires_grad=True)
    cols = w_col.shape[1] // 2
    wc = torch.tensor(w_col[:, m * cols:(m + 1) * cols], requires_grad=True)
    y = collectives.gather(collectives.copy_to(xt, mesh) @ wc, mesh)
    (torch.tensor(c) * y).sum().backward()
    out["col"] = (xt.grad.numpy(), wc.grad.numpy())

    rows = w_row.shape[0] // 2
    xl = torch.tensor(x[:, m * rows:(m + 1) * rows], requires_grad=True)
    wr = torch.tensor(w_row[m * rows:(m + 1) * rows], requires_grad=True)
    z = collectives.reduce_from(xl @ wr, mesh)
    (torch.tensor(c[:, :z.shape[1]]) * z).sum().backward()
    out["row"] = (xl.grad.numpy(), wr.grad.numpy())

    half = w_fsdp.shape[0] // 2
    wf = torch.tensor(w_fsdp[d * half:(d + 1) * half], requires_grad=True)
    full = collectives.gather_param(wf, mesh, 0)
    (torch.tensor(xs[d]) @ full).square().sum().backward()
    out["fsdp"] = wf.grad.numpy()
    return multihost.all_gather_objects(out)


def pool_worker(rank, world, feats, counts, out_dtypes, other):
    """ops/pooling.spatio_temporal_pool_sharded over make_mesh(world, 1)
    (frames on 'data') on the CPU: `feats` at each valid count and
    output dtype, then `other` (a shape the sharded form does not take)
    whole."""
    from video_llava_tpu_torch.ops.pooling import (
        spatio_temporal_pool_sharded,
    )
    from video_llava_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(world, 1)
    x = torch.from_numpy(feats)
    got = {(n, str(dt)): spatio_temporal_pool_sharded(
        x, n, mesh, out_dtype=getattr(torch, dt)).float().numpy()
        for n in counts for dt in out_dtypes}
    got["other"] = spatio_temporal_pool_sharded(
        torch.from_numpy(other), None, mesh,
        out_dtype=torch.float32).numpy()
    return got


def train_worker(rank, world, tree, cfg, batches, mesh_shape, mode, fsdp,
                 opt, watch, grad_accum=1):
    """The port's sharded train step: the model of `tree` sharded over
    make_mesh(*mesh_shape) (FSDP when `fsdp`), `mode` tuned, one step a
    global batch of `batches` on this rank's rows -> per step the loss,
    the grad norm and the parameters named in `watch` whole (gathered to
    rank 0)."""
    from video_llava_tpu_torch.engine.convert import params_from_jax
    from video_llava_tpu_torch.ops.attention import set_attention_mesh
    from video_llava_tpu_torch.parallel.mesh import make_mesh
    from video_llava_tpu_torch.parallel.sharding import (
        gather_to_first,
        shard_params,
    )
    from video_llava_tpu_torch.train import train_step as tts

    mesh = make_mesh(*mesh_shape)
    model = params_from_jax(tree, cfg)
    shard_params(model, mesh, fsdp=fsdp)
    set_attention_mesh(mesh)
    names = tts.trainable_mask(model, mode)
    tx = tts.make_optimizer(*opt)
    state = tts.init_train_state(model, tx, names)
    step = tts.make_train_step(tx, grad_accum, mesh=mesh)
    out = []
    for batch in batches:
        state, metrics = step(state, local_rows(batch, mesh))
        params = dict(model.named_parameters())
        whole = {n: gather_to_first(params[n], n, model) for n in watch}
        out.append({"loss": float(metrics["loss"]),
                    "grad_norm": float(metrics["grad_norm"]),
                    "params": {n: None if t is None else t.float().numpy()
                               for n, t in whole.items()}})
    return {"steps": out, "trainable": names}


def clip_a8_worker(rank, world, tree, cfg, pixels):
    """The video encode of the tiny model with its CLIP tower quantized
    to W8A8 (every linear), sharded over make_mesh(1, world)."""
    from video_llava_tpu_torch.engine.convert import params_from_jax
    from video_llava_tpu_torch.models.clip import quantize_a8_
    from video_llava_tpu_torch.parallel.mesh import make_mesh
    from video_llava_tpu_torch.parallel.sharding import shard_params

    model = params_from_jax(tree, cfg)
    quantize_a8_(model.vision, min_size=0)
    if world > 1:
        shard_params(model, make_mesh(1, world))
    with torch.inference_mode():
        return model.encode_video(torch.from_numpy(pixels)).float().numpy()
