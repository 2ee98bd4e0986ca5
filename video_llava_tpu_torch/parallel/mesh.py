"""The ('data', 'model') mesh of ranks and its collectives.

Counterpart of video_llava_tpu/parallel/mesh.py. A mesh here is the
shape of the grid, this rank's coordinates in it and the process group
of its 'model' axis; each rank is one process (torch.distributed,
initialized by parallel/multihost.init_distributed). The collectives a
tensor-parallel forward needs are methods of the mesh:

  * :meth:`Mesh.all_sum`: the sum of every rank's tensor, in place (the
    partial products of a row-sharded linear);
  * :meth:`Mesh.gather_last`: the ranks' tensors concatenated along the
    last axis in rank order (a column-sharded output made whole), through
    multihost.gather_rows (an all_reduce of a zero buffer, as gloo
    gathers no CUDA tensors);
  * :meth:`Mesh.broadcast_first`: the first rank's tensor on every rank
    (a sampled token).

A collective on rank 0 outside a call that parallel/driver.py
replicates to the other ranks would wait for ranks that never come, so
it raises instead.

Only the 'model' axis is ported: ``data > 1`` raises.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from video_llava_tpu_torch.parallel import multihost

AXES = ("data", "model")


class Mesh:
    """A ('data', 'model') grid: `shape` {'data': 1, 'model': m}, this
    rank's `coords`, and `group`, the process group of the 'model' axis
    (None for the default group; unused when m == 1)."""

    def __init__(self, data: int, model: int, model_rank: int = 0,
                 group=None, ranks=(0,)):
        self.shape = {"data": data, "model": model}
        self.axis_names = AXES
        self.coords = {"data": 0, "model": model_rank}
        self.group = group
        self.ranks = tuple(ranks)  # global ranks along 'model'

    @property
    def size(self) -> int:
        return self.shape["model"]

    @property
    def rank(self) -> int:
        return self.coords["model"]

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape['data']}, model={self.size}, "
                f"rank={self.rank})")

    # -- collectives --------------------------------------------------------

    def _check(self) -> None:
        from video_llava_tpu_torch.parallel import driver

        driver.check_collective()

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum x over the 'model' axis, in place; returns x."""
        if self.size > 1:
            self._check()
            dist.all_reduce(x, group=self.group)
        return x

    def gather_last(self, x: torch.Tensor) -> torch.Tensor:
        """(..., w) on each rank -> (..., size * w), the ranks' parts in
        rank order."""
        if self.size == 1:
            return x
        self._check()
        out = multihost.gather_rows(x, self.group)
        return out.movedim(0, -2).reshape(*x.shape[:-1],
                                          self.size * x.shape[-1])

    def broadcast_first(self, x: torch.Tensor) -> torch.Tensor:
        """The first 'model' rank's x on every rank, in place."""
        if self.size > 1:
            self._check()
            dist.broadcast(x, src=self.ranks[0], group=self.group)
        return x


def make_mesh(data: int = 1, model: Optional[int] = None,
              world_size: Optional[int] = None) -> Mesh:
    """Build a ('data', 'model') mesh over the first data * model ranks
    of the initialized process group (one rank without one). model=None
    uses every rank. Errors as the JAX package's make_mesh; data > 1
    (data-parallel and FSDP training) is not ported yet."""
    if world_size is None:
        world_size = (dist.get_world_size() if dist.is_initialized() else 1)
    n = world_size
    if model is None:
        if n % data:
            raise ValueError(f"{n} devices not divisible by data={data}")
        model = n // data
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} exceeds {n} devices")
    if data > 1:
        raise NotImplementedError(
            f"mesh data={data}: the 'data' axis (data-parallel and FSDP "
            "training) is the next slice of the port, ROADMAP Queue 1 "
            "item 9b")
    if model == 1:
        rank = dist.get_rank() if dist.is_initialized() else 0
        return Mesh(1, 1, 0, None, (rank,))
    rank = dist.get_rank()
    ranks = tuple(range(model))
    group = None if model == n else dist.new_group(list(ranks))
    if rank >= model:
        raise ValueError(f"rank {rank} is outside the {data}x{model} mesh")
    return Mesh(1, model, rank, group, ranks)


def single_device_mesh() -> Mesh:
    return make_mesh(1, 1)
