"""Rank 0 drives; the other ranks follow.

Tensor-parallel inference runs one process a rank, each holding its
shard of the model (parallel/sharding.py), and every forward needs every
rank: a collective waits until each rank reaches it. Only rank 0 talks
to the user (the chat REPL, the HTTP server, the answers file), so the
other ranks follow it here. The objects that run forwards (the
InferenceEngine, a ContinuousEngine, the serving ChatModel, the chat
interface) are built on every rank in the same order and registered;
each method of theirs that computes is marked :func:`replicated`. When
rank 0 calls one, the call (the object's registry index, the method's
name and the pickled arguments) is broadcast first, and then every rank
runs it, so every rank takes the same path through the same forwards
and meets the same collectives. The host logic above those methods
(request queues, batching windows, stop strings, timers) runs on rank 0
alone and reaches the followers only through the calls it makes.

Pickling rules of a call: a registered object travels as its index; a
tensor as its bytes, placed on the receiving rank's device when it was
on a card; a function, a lambda or a bound method (a streaming
callback) as a no-op, since only rank 0 talks to the user; a
torch.Generator as None (sampled tokens are drawn on rank 0 and
broadcast, engine/generate.sample_token). Construction is replicated
too: :func:`new` builds an object on every rank and registers it.

Such a callback, passed as an argument of the call, runs on rank 0
alone, so an exception of its own (a streaming client that hung up)
must not end rank 0's call early: the followers would go on to the next
collective of the call, and rank 0's next broadcast would meet it. On
rank 0 it is latched: its first exception is kept, it does nothing from
then on, the call runs to its end on every rank in step, and then rank
0 raises the kept exception. (A callback held inside an argument, as a
continuous engine's SlotRequest holds one, is the engine's to latch.)

Rank 0 serializes replicated calls with one lock (a scheduler thread
and HTTP threads take turns), so the followers see them in the order
rank 0 ran them. A collective on rank 0 outside a replicated call
raises (mesh.Mesh), rather than waiting for ranks that never join.
Shutdown is collective (:func:`stop` sends the followers home); a
follower that exits makes rank 0's next call raise, through the
process-group error (gloo reports a closed connection at once) or, for
a spawned follower, through its exit code, and every collective has a
timeout (multihost.TIMEOUT_S). While rank 0 is idle it sends a ping each
quarter of that timeout, so an idle follower never times out.

How the ranks start: under torchrun every rank runs the entry point
with its RANK / WORLD_SIZE; otherwise rank 0 spawns the other m - 1
(torch.multiprocessing, start method spawn), each running the same
entry point with the same arguments and its rank.
"""

from __future__ import annotations

import functools
import importlib
import io
import logging
import os
import pickle
import sys
import threading
import time
import types
from typing import Any, List, Optional, Sequence

import torch
import torch.distributed as dist

from video_llava_tpu_torch.parallel import multihost

log = logging.getLogger(__name__)

_ENV_RANK, _ENV_WORLD, _ENV_INIT = ("VLT_TP_RANK", "VLT_TP_WORLD",
                                    "VLT_TP_INIT")
_CALLABLES = (types.FunctionType, types.MethodType, functools.partial)


def _noop(*args, **kwargs):
    return None


def _latch(arg, failures: list):
    """`arg`, or, where it is a callback the followers receive as a
    no-op, a wrapper that keeps its first exception in `failures` and
    does nothing from then on."""
    if not isinstance(arg, _CALLABLES) or _importable(arg):
        return arg

    def latched(*args, **kwargs):
        if failures:
            return None
        try:
            return arg(*args, **kwargs)
        except Exception as e:  # noqa: BLE001 (raised after the call)
            failures.append(e)
            return None

    return latched


class Session:
    """What :func:`start` gives an entry point: this rank, the world
    size, this rank's device (as the caller named it on one rank), and
    whether it follows (rank > 0)."""

    def __init__(self, rank: int, world_size: int, device: torch.device):
        self.rank, self.world_size, self.device = rank, world_size, device

    @property
    def follower(self) -> bool:
        return self.rank > 0


def _importable(fn) -> bool:
    """A module-level function (pickled by reference, as the reduce
    protocol names its reconstructors), not a lambda, closure, bound
    method or partial."""
    if isinstance(fn, (types.MethodType, functools.partial)):
        return False
    module = sys.modules.get(getattr(fn, "__module__", None) or "")
    obj = module
    for part in getattr(fn, "__qualname__", "<lambda>").split("."):
        obj = getattr(obj, part, None)
    return obj is fn


class _Pickler(pickle.Pickler):
    def __init__(self, f, ids):
        super().__init__(f, protocol=pickle.HIGHEST_PROTOCOL)
        self.ids = ids

    def persistent_id(self, obj):
        if isinstance(obj, _CALLABLES) and not _importable(obj):
            return ("noop",)
        if isinstance(obj, torch.Tensor):
            t = obj.detach().cpu().contiguous()
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16)
            return ("tensor", t.numpy(), str(obj.dtype).split(".")[-1],
                    obj.device.type)
        if isinstance(obj, torch.Generator):
            return ("none",)
        idx = self.ids.get(id(obj))
        return None if idx is None else ("ref", idx)


class _Unpickler(pickle.Unpickler):
    def __init__(self, f, objects, device):
        super().__init__(f)
        self.objects, self.device = objects, device

    def persistent_load(self, pid):
        kind = pid[0]
        if kind == "tensor":
            _, arr, dtype, devtype = pid
            t = torch.from_numpy(arr.copy()).view(getattr(torch, dtype))
            return t.to(self.device) if devtype == "cuda" else t
        if kind == "ref":
            return self.objects[pid[1]]
        if kind == "noop":
            return _noop
        return None


class _Driver:
    def __init__(self, session: Session, procs: Sequence = ()):
        self.session = session
        self.leader = session.rank == 0
        self.objects: List[Any] = []
        self.ids = {}
        self.procs = list(procs)  # spawned followers (rank 0, self-spawn)
        self.lock = threading.RLock()
        self.local = threading.local()
        self.cdev = (torch.device("cuda", torch.cuda.current_device())
                     if dist.get_backend() == "nccl" else torch.device("cpu"))
        self.last_send = time.monotonic()
        self.closed = threading.Event()
        if self.leader:
            threading.Thread(target=self._beat, daemon=True).start()

    # -- registry -----------------------------------------------------------

    def register(self, obj) -> None:
        self.ids[id(obj)] = len(self.objects)
        self.objects.append(obj)

    @property
    def depth(self) -> int:
        return getattr(self.local, "depth", 0)

    def leading(self) -> bool:
        return self.leader and self.depth == 0

    # -- transport ----------------------------------------------------------

    def send(self, msg) -> None:
        buf = io.BytesIO()
        _Pickler(buf, self.ids).dump(msg)
        payload = buf.getbuffer()
        n = torch.tensor([len(payload)], dtype=torch.int64, device=self.cdev)
        dist.broadcast(n, src=0)
        data = torch.frombuffer(bytearray(payload), dtype=torch.uint8)
        dist.broadcast(data.to(self.cdev), src=0)
        self.last_send = time.monotonic()

    def recv(self):
        n = torch.zeros((1,), dtype=torch.int64, device=self.cdev)
        dist.broadcast(n, src=0)
        data = torch.empty((int(n[0]),), dtype=torch.uint8, device=self.cdev)
        dist.broadcast(data, src=0)
        return _Unpickler(io.BytesIO(data.cpu().numpy().tobytes()),
                          self.objects, self.session.device).load()

    def check_followers(self) -> None:
        for rank, p in enumerate(self.procs, start=1):
            if p.exitcode is not None:
                raise RuntimeError(f"tensor-parallel follower rank {rank} "
                                   f"exited with code {p.exitcode}")

    def _beat(self) -> None:
        period = multihost.TIMEOUT_S / 4
        while not self.closed.wait(min(period, 5.0)):
            if time.monotonic() - self.last_send < period:
                continue
            with self.lock:
                if self.closed.is_set():
                    return
                try:
                    self.send(("ping",))
                except Exception:  # noqa: BLE001 (the next call raises)
                    return

    # -- rank 0 -------------------------------------------------------------

    def _enter(self, msg):
        self.check_followers()
        self.send(msg)
        self.local.depth = self.depth + 1

    def call(self, obj, method, args, kwargs):
        idx = self.ids.get(id(obj))
        if idx is None:
            raise RuntimeError(
                f"{type(obj).__name__}.{method.__name__}: a replicated call "
                "on an object the followers do not hold (build it with "
                "parallel.driver.new)")
        failures: list = []
        args = tuple(_latch(a, failures) for a in args)
        kwargs = {k: _latch(v, failures) for k, v in kwargs.items()}
        with self.lock:
            self._enter(("call", idx, method.__name__, args, kwargs))
            try:
                out = method(obj, *args, **kwargs)
            finally:
                self.local.depth -= 1
        if failures:
            raise failures[0]
        return out

    def new(self, cls, args, kwargs):
        with self.lock:
            self._enter(("new", cls, args, kwargs))
            try:
                obj = cls(*args, **kwargs)
            except BaseException:
                self.register(None)
                raise
            finally:
                self.local.depth -= 1
            self.register(obj)
            return obj

    # -- followers ----------------------------------------------------------

    def follow(self) -> None:
        while True:
            msg = self.recv()
            kind = msg[0]
            if kind == "stop":
                return
            # a follower whose call fails is out of step with rank 0: it
            # stops (the exception ends the process), and rank 0's next
            # collective raises on the closed connection
            if kind == "call":
                _, idx, name, args, kwargs = msg
                getattr(self.objects[idx], name)(*args, **kwargs)
            elif kind == "new":
                _, cls, args, kwargs = msg
                self.register(cls(*args, **kwargs))


_driver: Optional[_Driver] = None


def active() -> bool:
    return _driver is not None


def register(obj):
    """Register `obj` (built on every rank in the same order, as
    initialize_model builds the engine) so calls and arguments can name
    it. Returns obj. Nothing happens without a driver."""
    if _driver is not None:
        _driver.register(obj)
    return obj


def replicated(method):
    """Mark a method that runs forwards: called on rank 0 outside
    another replicated call, it is broadcast to the followers first,
    then run on every rank."""

    @functools.wraps(method)
    def wrapper(self, *args, **kwargs):
        d = _driver
        if d is None or not d.leading():
            return method(self, *args, **kwargs)
        return d.call(self, method, args, kwargs)

    return wrapper


def new(cls, *args, **kwargs):
    """cls(*args, **kwargs), built on every rank and registered under a
    driver (on rank 0); else just built."""
    d = _driver
    if d is None or not d.leading():
        return cls(*args, **kwargs)
    return d.new(cls, args, kwargs)


def check_collective() -> None:
    """Raise on rank 0 outside a replicated call (the followers would
    never join the collective)."""
    d = _driver
    if d is not None and d.leading():
        raise RuntimeError(
            "a tensor-parallel collective on rank 0 outside a replicated "
            "call: the other ranks would never join it")


def follow() -> None:
    """Run rank 0's calls until it stops the followers."""
    _driver.follow()


def _follower_entry(module: str, fn: str, argv, rank: int, world: int,
                    init_method: str) -> None:
    os.environ[_ENV_RANK] = str(rank)
    os.environ[_ENV_WORLD] = str(world)
    os.environ[_ENV_INIT] = init_method
    getattr(importlib.import_module(module), fn)(argv)


def start(mesh_model: Optional[int], backend: str = "gloo",
          init_method: Optional[str] = None, device="cuda",
          entry: Optional[tuple] = None, argv=None) -> Session:
    """Join (or, on rank 0 without torchrun, spawn) the ranks of a
    `mesh_model`-way tensor-parallel run and start the driver; one rank
    without a mesh. `entry` = (module, function) is what a spawned
    follower runs with `argv` (the entry point's own arguments); each
    rank's device is multihost.rank_device's."""
    global _driver
    if not mesh_model or mesh_model <= 1:
        return Session(0, 1, device)
    if _driver is not None:
        raise RuntimeError("a tensor-parallel driver is already running")
    if backend not in multihost.BACKENDS:
        raise ValueError(f"--dist_backend: one of {multihost.BACKENDS}, "
                         f"got {backend!r}")
    spawn = False
    if _ENV_RANK in os.environ:  # a follower this package spawned
        rank, world = int(os.environ[_ENV_RANK]), int(os.environ[_ENV_WORLD])
        init_method = os.environ[_ENV_INIT]
    elif "WORLD_SIZE" in os.environ:  # torchrun
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        init_method = "env://"
    else:
        rank, world, spawn = 0, mesh_model, True
        if init_method is None:
            init_method = f"tcp://localhost:{multihost.free_localhost_port()}"
        if entry is None:
            raise ValueError("spawning followers needs the entry point")
    if world != mesh_model:
        raise ValueError(f"--mesh_model {mesh_model} over {world} ranks: "
                         "launch one rank a model shard")
    # checked before any follower starts
    dev = multihost.rank_device(device, rank, backend, world)
    procs = []
    if spawn:
        ctx = torch.multiprocessing.get_context("spawn")
        for r in range(1, world):
            p = ctx.Process(target=_follower_entry,
                            args=(entry[0], entry[1], argv, r, world,
                                  init_method), daemon=True)
            p.start()
            procs.append(p)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    try:
        multihost.init_distributed(backend, init_method, world, rank)
    except BaseException:
        for p in procs:
            p.terminate()
        raise
    session = Session(rank, world, dev)
    _driver = _Driver(session, procs)
    return session


def stop(join_timeout: float = 60.0) -> None:
    """End a tensor-parallel run: rank 0 sends the followers home; every
    rank leaves the process group and forgets the pooling mesh
    (runtime/model_init registered it); rank 0 waits for the followers
    it spawned and raises if one failed."""
    from video_llava_tpu_torch.ops.pooling import set_pooling_mesh

    global _driver
    set_pooling_mesh(None)
    d = _driver
    if d is None:
        return
    _driver = None
    d.closed.set()
    try:
        if d.leader:
            with d.lock:
                try:
                    d.send(("stop",))
                except Exception:  # noqa: BLE001 (a follower is gone)
                    log.exception("could not stop the followers")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        failed = []
        for rank, p in enumerate(d.procs, start=1):
            p.join(join_timeout)
            if p.exitcode is None:
                p.terminate()
                p.join(5)
            if p.exitcode != 0:
                failed.append((rank, p.exitcode))
    if failed:
        raise RuntimeError(f"tensor-parallel followers failed: {failed}")
