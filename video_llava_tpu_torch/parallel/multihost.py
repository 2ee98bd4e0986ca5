"""Multi-process utilities over torch.distributed.

Counterpart of video_llava_tpu/parallel/multihost.py (the reference's
grounding_evaluation/util/dist.py helpers): the rendezvous and the
gathers of host objects. One process is one rank; on a single process
every function here does nothing or returns its input, as the JAX
ones do.

The backend is chosen by the caller, never guessed: 'nccl' needs a card
a rank and raises, naming --dist_backend, when the machine has fewer
cards than ranks; 'gloo' runs on the CPU and also lets several ranks
share one card (it moves CUDA tensors through the host). The rendezvous
comes from torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR, MASTER_PORT) when it is set, else from `init_method`
(``tcp://localhost:<port>`` or ``file://<path>``). :func:`start_ranks`
starts the ranks of an SPMD run (sharded training), where every rank
runs the whole program: torchrun's, or spawned by rank 0.
"""

from __future__ import annotations

import datetime
import importlib
import os
import pickle
import socket
from typing import Any, List, Optional

import numpy as np
import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")
# seconds a collective may wait for its peers before it raises
TIMEOUT_S = 600.0


def free_localhost_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_device(device: str, rank: int, backend: str,
                world_size: int) -> torch.device:
    """The device of `rank`: the CPU for a CPU run; with nccl card
    `rank` (one a rank); with gloo card `rank` modulo the cards there
    are (so ranks may share a card)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        if backend == "nccl":
            raise ValueError("--dist_backend nccl needs CUDA devices; use "
                             "--dist_backend gloo on the CPU")
        return dev
    n = torch.cuda.device_count()
    if backend == "nccl" and n < world_size:
        raise ValueError(
            f"--dist_backend nccl needs a card a rank: {world_size} ranks, "
            f"{n} card(s); use --dist_backend gloo to share cards")
    return torch.device("cuda", rank % max(n, 1))


def init_distributed(backend: str = "gloo",
                     init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None) -> None:
    """Join the process group (reference init_distributed_mode). With
    torchrun's environment, its RANK and WORLD_SIZE; else the given
    ones. Does nothing for one process or when already joined."""
    if backend not in BACKENDS:
        raise ValueError(f"--dist_backend: one of {BACKENDS}, got "
                         f"{backend!r}")
    if dist.is_initialized():
        return
    if "WORLD_SIZE" in os.environ and world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
        init_method = init_method or "env://"
    if not world_size or world_size == 1:
        return
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))


_ENV_RANK, _ENV_WORLD, _ENV_INIT = ("VLT_SPMD_RANK", "VLT_SPMD_WORLD",
                                    "VLT_SPMD_INIT")


def _rank_entry(module: str, fn: str, argv, rank: int, world: int,
                init_method: str) -> None:
    os.environ[_ENV_RANK] = str(rank)
    os.environ[_ENV_WORLD] = str(world)
    os.environ[_ENV_INIT] = init_method
    getattr(importlib.import_module(module), fn)(argv)


def launched_world() -> Optional[int]:
    """The world size a launcher gave this process (torchrun, or
    :func:`start_ranks` spawning it), None when nothing launched it."""
    for key in (_ENV_WORLD, "WORLD_SIZE"):
        if key in os.environ:
            return int(os.environ[key])
    return None


def start_ranks(world: int, backend: str = "gloo",
                init_method: Optional[str] = None, device="cuda",
                entry: Optional[tuple] = None, argv=None):
    """Join the `world` ranks of an SPMD run, where every rank runs the
    whole program (sharded training): under torchrun with its RANK and
    WORLD_SIZE; otherwise this process is rank 0 and spawns the other
    world - 1 (start method spawn), each calling entry = (module,
    function) with `argv`. Returns (rank, this rank's device, the
    processes spawned); one rank joins nothing."""
    if world <= 1:
        return 0, torch.device(device), []
    spawn = False
    if _ENV_RANK in os.environ:  # a rank this function spawned
        rank, init_method = (int(os.environ[_ENV_RANK]),
                             os.environ[_ENV_INIT])
        got = int(os.environ[_ENV_WORLD])
    elif "WORLD_SIZE" in os.environ:  # torchrun
        rank, got, init_method = (int(os.environ["RANK"]),
                                  int(os.environ["WORLD_SIZE"]), "env://")
    else:
        rank, got, spawn = 0, world, True
        if init_method is None:
            init_method = f"tcp://localhost:{free_localhost_port()}"
        if entry is None:
            raise ValueError("spawning ranks needs the entry point")
    if got != world:
        raise ValueError(f"a mesh of {world} ranks launched as {got}")
    dev = rank_device(device, rank, backend, world)  # before any spawn
    procs = []
    if spawn:
        ctx = torch.multiprocessing.get_context("spawn")
        for r in range(1, world):
            p = ctx.Process(target=_rank_entry,
                            args=(entry[0], entry[1], argv, r, world,
                                  init_method), daemon=True)
            p.start()
            procs.append(p)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:  # ranks on one host's CPU split its cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    try:
        init_distributed(backend, init_method, world, rank)
    except BaseException:
        for p in procs:
            p.terminate()
        raise
    return rank, dev, procs


def stop_ranks(procs, join_timeout: float = TIMEOUT_S) -> None:
    """Leave the process group and wait for the ranks this one spawned;
    raise if one failed (or had to be stopped)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    failed = []
    for rank, p in enumerate(procs, start=1):
        p.join(join_timeout)
        if p.exitcode is None:
            p.terminate()
            p.join(5)
        if p.exitcode != 0:
            failed.append((rank, p.exitcode))
    if failed:
        raise RuntimeError(f"ranks failed: {failed}")


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def get_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    return get_rank() == 0


def gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """x on each rank of `group` (the default group for None) ->
    (ranks, *x.shape) in rank order, as an all_reduce of a zero buffer
    with this rank's row written in: gloo gathers no CUDA tensors, and
    x + 0 is x exactly for any values."""
    out = x.new_zeros((dist.get_world_size(group),) + tuple(x.shape))
    out[dist.get_rank(group)] = x
    dist.all_reduce(out, group=group)
    return out


def _collective_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather_objects(obj: Any, max_bytes: int = 1 << 20) -> List[Any]:
    """Gather a picklable object from every rank (reference
    dist.all_gather, util/dist.py:34-66): pickled into a padded byte
    buffer, gathered, unpickled per rank, in rank order."""
    if get_world_size() == 1:
        return [obj]
    payload = pickle.dumps(obj)
    if len(payload) > max_bytes - 8:
        raise ValueError(f"object too large: {len(payload)} > {max_bytes - 8}")
    buf = np.zeros((max_bytes,), np.uint8)
    buf[:8] = np.frombuffer(np.int64(len(payload)).tobytes(), np.uint8)
    buf[8:8 + len(payload)] = np.frombuffer(payload, np.uint8)
    rows = gather_rows(torch.from_numpy(buf).to(
        _collective_device())).cpu().numpy()
    out = []
    for row in rows:
        n = int(np.frombuffer(row[:8].tobytes(), np.int64)[0])
        out.append(pickle.loads(row[8:8 + n].tobytes()))
    return out


def reduce_dict(d: dict, average: bool = True) -> dict:
    """Cross-rank mean (or sum) of a {name: scalar} dict (reference
    reduce_dict, util/dist.py:98-122), in f32 as the JAX one gathers."""
    if get_world_size() == 1:
        return dict(d)
    keys = sorted(d)
    vals = torch.tensor([float(d[k]) for k in keys], dtype=torch.float32,
                        device=_collective_device())
    rows = gather_rows(vals).cpu().numpy()
    agg = rows.mean(axis=0) if average else rows.sum(axis=0)
    return {k: float(v) for k, v in zip(keys, agg)}
