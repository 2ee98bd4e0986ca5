"""The ('data', 'model') mesh of ranks and its collectives.

Counterpart of video_llava_tpu/parallel/mesh.py. A mesh here is the
shape of the grid, this rank's coordinates in it and one process group
for each axis; each rank is one process (torch.distributed, initialized
by parallel/multihost.init_distributed). The ranks are laid out as the
JAX package lays out its devices (``reshape(data, model)``): global rank
``d * model + m`` sits at {'data': d, 'model': m}, its 'model' group is
the row of its data coordinate and its 'data' group the column of its
model coordinate.

The collectives a forward needs are methods of the mesh, each taking
the axis it runs over ('model' unless told otherwise):

  * :meth:`Mesh.all_sum`: the sum of every rank's tensor, in place (the
    partial products of a row-sharded linear);
  * :meth:`Mesh.gather`: the ranks' tensors concatenated along a
    dimension in rank order (a column-sharded output made whole, an
    FSDP shard gathered at use), through multihost.gather_rows (an
    all_reduce of a zero buffer, as gloo gathers no CUDA tensors);
  * :meth:`Mesh.all_max`: the elementwise maximum (a W8A8 row scale over
    a row-sharded contraction);
  * :meth:`Mesh.broadcast_first`: the first rank's tensor on every rank
    (a sampled token).

These run outside autograd: parallel/collectives.py wraps them in
autograd Functions for training. A collective on rank 0 outside a call
that parallel/driver.py replicates to the other ranks would wait for
ranks that never come, so it raises instead (training runs every rank's
loop itself and starts no driver).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

from video_llava_tpu_torch.parallel import multihost

AXES = ("data", "model")


class Mesh:
    """A ('data', 'model') grid: `shape` {'data': d, 'model': m}, this
    rank's `coords`, and for each axis its process group (`groups`, None
    for the default group or a size-1 axis) and the global ranks along
    it (`axis_ranks`). The positional arguments describe the 'model'
    axis (its rank, group and global ranks); `data_rank`, `data_group`
    and `data_ranks` the 'data' axis."""

    def __init__(self, data: int, model: int, model_rank: int = 0,
                 group=None, ranks: Sequence[int] = (0,), *,
                 data_rank: int = 0, data_group=None,
                 data_ranks: Sequence[int] = (0,)):
        self.shape = {"data": data, "model": model}
        self.axis_names = AXES
        self.coords = {"data": data_rank, "model": model_rank}
        self.groups: Dict[str, object] = {"data": data_group,
                                          "model": group}
        self.axis_ranks = {"data": tuple(data_ranks), "model": tuple(ranks)}

    # 'model'-axis views, as tensor-parallel inference reads them
    @property
    def size(self) -> int:
        return self.shape["model"]

    @property
    def rank(self) -> int:
        return self.coords["model"]

    @property
    def group(self):
        return self.groups["model"]

    @property
    def ranks(self):
        return self.axis_ranks["model"]

    @property
    def world(self) -> int:
        return self.shape["data"] * self.shape["model"]

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape['data']}, model={self.size}, "
                f"coords={self.coords})")

    # -- collectives --------------------------------------------------------

    def _check(self) -> None:
        from video_llava_tpu_torch.parallel import driver

        driver.check_collective()

    def all_sum(self, x: torch.Tensor, axis: str = "model") -> torch.Tensor:
        """Sum x over `axis`, in place; returns x."""
        if self.shape[axis] > 1:
            self._check()
            dist.all_reduce(x, group=self.groups[axis])
        return x

    def all_max(self, x: torch.Tensor, axis: str = "model") -> torch.Tensor:
        """The elementwise maximum of x over `axis`, in place."""
        if self.shape[axis] > 1:
            self._check()
            dist.all_reduce(x, op=dist.ReduceOp.MAX, group=self.groups[axis])
        return x

    def gather(self, x: torch.Tensor, dim: int = -1,
               axis: str = "model") -> torch.Tensor:
        """x on each rank of `axis` -> the ranks' x concatenated along
        `dim` in rank order."""
        n = self.shape[axis]
        if n == 1:
            return x
        self._check()
        rows = multihost.gather_rows(x.contiguous(), self.groups[axis])
        return torch.cat(rows.unbind(0), dim=dim)

    def broadcast_first(self, x: torch.Tensor) -> torch.Tensor:
        """The first 'model' rank's x on every rank, in place."""
        if self.size > 1:
            self._check()
            dist.broadcast(x, src=self.ranks[0], group=self.group)
        return x


def _group(ranks, world: int):
    return None if len(ranks) == world else dist.new_group(list(ranks))


def mesh_shape(data: int, model: Optional[int], world: int):
    """(data, model) of a mesh over `world` ranks, model=None taking
    every rank; raises as the JAX package's make_mesh does."""
    if model is None:
        if world % data:
            raise ValueError(f"{world} devices not divisible by "
                             f"data={data}")
        model = world // data
    if data * model > world:
        raise ValueError(f"mesh {data}x{model} exceeds {world} devices")
    return data, model


def make_mesh(data: int = 1, model: Optional[int] = None,
              world_size: Optional[int] = None) -> Mesh:
    """Build a ('data', 'model') mesh over the first data * model ranks
    of the initialized process group (one rank without one). model=None
    uses every rank. Errors as the JAX package's make_mesh: a world the
    data axis does not divide, a grid larger than the world. Every rank
    of the world must call it (process groups are made collectively);
    a rank outside the grid raises after that."""
    if world_size is None:
        world_size = (dist.get_world_size() if dist.is_initialized() else 1)
    n = world_size
    data, model = mesh_shape(data, model, n)
    rank = dist.get_rank() if dist.is_initialized() else 0
    if data * model == 1:
        return Mesh(1, 1, 0, None, (rank,), data_ranks=(rank,))
    # every rank makes every group, in the same order
    rows = [tuple(range(d * model, (d + 1) * model)) for d in range(data)]
    cols = [tuple(range(m, data * model, model)) for m in range(model)]
    row_groups = [_group(r, n) if model > 1 else None for r in rows]
    col_groups = [_group(c, n) if data > 1 else None for c in cols]
    if rank >= data * model:
        raise ValueError(f"rank {rank} is outside the {data}x{model} mesh")
    d, m = divmod(rank, model)
    return Mesh(data, model, m, row_groups[d], rows[d], data_rank=d,
                data_group=col_groups[m], data_ranks=cols[m])


def single_device_mesh() -> Mesh:
    return make_mesh(1, 1)
