"""parallel/multihost.py beside the JAX package's: on one process every
helper does nothing or returns its input, as JAX tests/test_multihost.py
checks of its own; over 2 gloo ranks spawned on the CPU,
all_gather_objects returns every rank's object in rank order and
reduce_dict the mean (or sum) of every rank's scalars, which is what the
JAX helpers give over 2 hosts; and the mesh and driver entry points take
one process without a process group; a follower that dies makes rank
0's next replicated call raise, and the driver's stop report it."""

import time

import numpy as np
import pytest
import torch

from torch_tp_pair import Counter, multihost_worker, run_ranks
from video_llava_tpu.parallel import multihost as jmh
from video_llava_tpu_torch.parallel import driver, multihost
from video_llava_tpu_torch.parallel.mesh import make_mesh, single_device_mesh


def test_multihost_single_and_two_ranks(tmp_path):
    jmh.init_distributed(num_processes=1)
    multihost.init_distributed("gloo")
    for mod in (jmh, multihost):
        assert mod.get_world_size() == 1
        assert mod.get_rank() == 0
        assert mod.is_main_process()
        assert mod.all_gather_objects({"a": [1, 2]}) == [{"a": [1, 2]}]
        assert mod.reduce_dict({"loss": 2.0}) == {"loss": 2.0}
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="dist_backend"):
        multihost.init_distributed("mpi")
    # the mesh of one process; no driver without a mesh
    for mesh in (single_device_mesh(), make_mesh(1, 1), make_mesh()):
        assert mesh.shape == {"data": 1, "model": 1} and mesh.rank == 0
    with pytest.raises(ValueError, match="exceeds"):
        make_mesh(1, 2)
    with pytest.raises(ValueError, match="not divisible"):
        make_mesh(2, None, world_size=3)
    with pytest.raises(ValueError, match="exceeds"):
        make_mesh(2, 2, world_size=3)
    session = driver.start(None, device="cpu")
    assert (session.rank, session.world_size, session.follower) == (0, 1,
                                                                    False)
    assert not driver.active()
    driver.stop()

    out = run_ranks(multihost_worker, 2, tmp_path)
    assert (out["rank"], out["world"], out["main"]) == (0, 2, True)
    got = out["gathered"]
    assert [g["rank"] for g in got] == [0, 1]
    assert [g["name"] for g in got] == ["r", "rr"]
    for r, g in enumerate(got):
        np.testing.assert_array_equal(g["arr"], np.arange(r + 2))
    assert out["mean"] == {"acc": 0.125, "loss": 1.5}
    assert out["sum"] == {"n": 5.0}

    # a follower that dies: rank 0 (this process) raises at its next
    # replicated call instead of waiting, and stop() reports the exit
    driver.start(2, "gloo", f"file://{tmp_path}/die_store", "cpu",
                 entry=("torch_tp_pair", "dying_follower"), argv=[])
    try:
        counter = driver.register(Counter())
        t = time.monotonic()
        with pytest.raises(RuntimeError):
            for _ in range(100):
                counter.add(1)
                time.sleep(0.1)
        assert time.monotonic() - t < 60
    finally:
        with pytest.raises(RuntimeError, match="followers failed"):
            driver.stop()
    assert not torch.distributed.is_initialized() and not driver.active()
