"""The mesh's collectives as autograd Functions, for training.

The JAX package leaves these to GSPMD, which differentiates through the
collectives it places. Here each rank is a process and writes its
collectives out (parallel/mesh.py), so a training forward uses these
Functions, whose backward passes are the collectives' transposes
(Megatron's f and g, and ZeRO-3's gather at use):

  * :func:`copy_to`: into a column-parallel linear (the input is whole
    on every 'model' rank, each rank's product reads it): identity
    forward, the gradients of the ranks' products summed over 'model'
    backward;
  * :func:`reduce_from`: out of a row-parallel linear or the
    vocab-sharded lookup: the partial results summed over 'model'
    forward, identity backward (every rank's partial contributed to the
    sum with weight one);
  * :func:`gather`: a column-sharded output made whole: the ranks' parts
    concatenated forward, this rank's slice of the gradient backward;
  * :func:`gather_param`: FSDP's gather of a parameter's 'data' shards
    at use: concatenated over 'data' forward; backward, the gradient of
    the whole parameter summed over 'data' (each data rank's rows
    contributed one part of it), then this rank's slice, so the
    data-parallel reduction of an FSDP leaf happens here.

Sums run in the tensor's own dtype, as the inference path's do (over
the two ranks of an axis, the one addition a + b rounds as an f32 sum
would). Gloo gathers and
reduce-scatters no CUDA tensors, so a gather is an all_reduce of a zero
buffer with this rank's part written in (multihost.gather_rows; x + 0 is
x exactly) and a reduce-scatter an all_reduce followed by the slice.
With no grad enabled (inference) the models call the mesh's in-place
collectives directly, as tensor-parallel inference always has.
"""

from __future__ import annotations

import torch


def summed(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """A new tensor: x summed over `axis`, in x's dtype."""
    if mesh.shape[axis] == 1:
        return x
    return mesh.all_sum(x.clone(), axis)


def _slice(x: torch.Tensor, mesh, dim: int, axis: str) -> torch.Tensor:
    n = x.shape[dim] // mesh.shape[axis]
    return x.narrow(dim, mesh.coords[axis] * n, n).contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        y = x.view_as(x)
        y._copied_to = axis  # copy_to of y is y itself
        return y

    @staticmethod
    def backward(ctx, g):
        return summed(g, ctx.mesh, ctx.axis), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return summed(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim, axis):
        ctx.mesh, ctx.dim, ctx.axis = mesh, dim, axis
        return mesh.gather(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.mesh, ctx.dim, ctx.axis), None, None, None


class _GatherParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, mesh, dim, axis):
        ctx.mesh, ctx.dim, ctx.axis = mesh, dim, axis
        return mesh.gather(w, dim, axis)

    @staticmethod
    def backward(ctx, g):
        g = summed(g.contiguous(), ctx.mesh, ctx.axis)
        return _slice(g, ctx.mesh, ctx.dim, ctx.axis), None, None, None


def _dim(x: torch.Tensor, dim: int) -> int:
    return dim % x.dim()


def copy_to(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """x into the column-sharded products that read it. Idempotent: a
    block whose linears share an input (q, k, v; gate, up) copies it
    once, and each linear's own copy_to is then the identity, so the
    input's gradient is summed over `axis` once, after autograd has
    added the linears' parts."""
    if (mesh.shape[axis] == 1 or not torch.is_grad_enabled()
            or getattr(x, "_copied_to", None) == axis):
        return x
    return _CopyTo.apply(x, mesh, axis)


def reduce_from(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """x summed over `axis`: a new tensor with grad enabled, else x
    summed in place (the inference path's all_sum)."""
    if mesh.shape[axis] == 1:
        return x
    if not torch.is_grad_enabled():
        return mesh.all_sum(x, axis)
    return _ReduceFrom.apply(x, mesh, axis)


def gather(x: torch.Tensor, mesh, dim: int = -1,
           axis: str = "model") -> torch.Tensor:
    if mesh.shape[axis] == 1:
        return x
    if not torch.is_grad_enabled():
        return mesh.gather(x, dim, axis)
    return _Gather.apply(x, mesh, _dim(x, dim), axis)


def gather_param(w: torch.Tensor, mesh, dim: int,
                 axis: str = "data") -> torch.Tensor:
    if mesh.shape[axis] == 1:
        return w
    if not torch.is_grad_enabled() or not w.requires_grad:
        return mesh.gather(w, dim, axis)
    return _GatherParam.apply(w, mesh, _dim(w, dim), axis)

