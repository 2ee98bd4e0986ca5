"""The ('data', 'model') mesh and the autograd collectives of the port's
parallel/ over 4 gloo ranks spawned on the CPU: make_mesh(2, 2) places
global rank r where the JAX package's make_mesh(2, 2) places device r
(its grid is reshape(data, model)), with each rank's 'model' group the
row of its data coordinate and its 'data' group the column of its model
coordinate (each group's sum of the ranks' numbers checks who is in it);
and each collective of parallel/collectives.py gives the gradients one
process's autograd gives the same products (f32, rtol 1e-5 atol 1e-6:
the sums over ranks add the same terms in another order)."""

import numpy as np
import torch

from torch_dp_pair import collectives_worker, grid_worker
from torch_tp_pair import run_ranks
from video_llava_tpu.parallel import make_mesh as jmake_mesh


def _grad(fn, *arrays):
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    fn(*ts).backward()
    return [t.grad.numpy() for t in ts]


def test_mesh_grid_and_autograd_collectives_match(tmp_path):
    jmesh = jmake_mesh(2, 2)
    grid = np.vectorize(lambda dev: dev.id)(jmesh.devices)
    got = run_ranks(grid_worker, 4, tmp_path, 2, 2)
    for r in got:
        d, m = r["coords"]["data"], r["coords"]["model"]
        assert grid[d, m] == r["rank"]
        assert r["axis_ranks"]["model"] == list(grid[d])
        assert r["axis_ranks"]["data"] == list(grid[:, m])
        assert r["sums"] == {"model": float(grid[d].sum()),
                             "data": float(grid[:, m].sum())}

    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 8)).astype(np.float32)
    w_col = rng.standard_normal((8, 6)).astype(np.float32)
    w_row = rng.standard_normal((8, 5)).astype(np.float32)
    w_fsdp = rng.standard_normal((4, 7)).astype(np.float32)
    xs = rng.standard_normal((2, 3, 4)).astype(np.float32)
    c = rng.standard_normal((3, 6)).astype(np.float32)
    out = run_ranks(collectives_worker, 4, tmp_path, x, w_col, w_row,
                    w_fsdp, xs, c)

    ct = torch.from_numpy(c)
    gx_col, gw_col = _grad(lambda a, w: (ct * (a @ w)).sum(), x, w_col)
    gx_row, gw_row = _grad(lambda a, w: (ct[:, :5] * (a @ w)).sum(), x,
                           w_row)
    # every data rank's loss on its own rows, summed: one process's loss
    (gw_fsdp,) = _grad(lambda w: sum((torch.from_numpy(xs[d]) @ w)
                                     .square().sum() for d in range(2)),
                       w_fsdp)
    tol = dict(rtol=1e-5, atol=1e-6)
    for r in out:
        d, m = r["coords"]
        np.testing.assert_allclose(r["col"][0], gx_col, **tol)
        np.testing.assert_allclose(r["col"][1], gw_col[:, 3 * m:3 * m + 3],
                                   **tol)
        np.testing.assert_allclose(r["row"][0], gx_row[:, 4 * m:4 * m + 4],
                                   **tol)
        np.testing.assert_allclose(r["row"][1], gw_row[4 * m:4 * m + 4],
                                   **tol)
        np.testing.assert_allclose(r["fsdp"], gw_fsdp[2 * d:2 * d + 2],
                                   **tol)
