"""Frame-sharded pooling (ops/pooling.spatio_temporal_pool_sharded) over
2 gloo ranks on the CPU (make_mesh(2, 1): frames on 'data', the plain
versions of kernel 2's sharded form) against the JAX package's
spatio_temporal_pool_sharded (its Pallas kernel in interpret mode,
shard_map over the 'data' axis of its (2, 4) virtual mesh), on 100
frames of 64 x 128 features (the shapes its sharded form takes) at valid
counts None, 100, 73 and 30 (at 30 the second rank holds no valid
frame). An f32 result within rtol 1e-5, atol 1e-6 (the same sums in
another order). A bf16 result within 4 bf16 half-ulps of the largest
value (atol 2^-6 * max|want|): JAX rounds each rank's spatial partial to
bf16 and adds them in bf16, the port adds f32 partials and rounds once.
A clip of t = 60 frames (not max_temporal_tokens) pools unsharded on
every rank, as JAX falls back, and equals the plain pooling. The
pooling mesh a tensor-parallel session registers ends with the session
(parallel/driver.stop), so later single-process pooling is unsharded."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from torch_dp_pair import pool_worker
from torch_tp_pair import run_ranks
from video_llava_tpu.ops.pooling import spatio_temporal_pool_sharded
from video_llava_tpu.parallel import make_mesh
from video_llava_tpu_torch.ops.pooling import (
    get_pooling_mesh,
    set_pooling_mesh,
    spatio_temporal_pool,
)
from video_llava_tpu_torch.parallel import driver

COUNTS = (None, 100, 73, 30)


def test_sharded_pooling_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((100, 64, 128)).astype(np.float32)
    other = rng.standard_normal((60, 64, 128)).astype(np.float32)
    mesh = make_mesh(2, 4)
    want = {}
    x = jnp.asarray(feats)
    for dt in ("float32", "bfloat16"):
        pool = jax.jit(lambda x, n: spatio_temporal_pool_sharded(
            x, n, mesh, out_dtype=getattr(jnp, dt), interpret=True))
        for n in COUNTS:
            out = (pool(x, jnp.asarray(n, jnp.int32)) if n is not None
                   else spatio_temporal_pool_sharded(
                       x, None, mesh, out_dtype=getattr(jnp, dt),
                       interpret=True))
            want[(n, dt)] = np.asarray(out).astype(np.float32)
    want_other = np.asarray(spatio_temporal_pool_sharded(
        jnp.asarray(other), None, mesh, out_dtype=jnp.float32,
        interpret=True))

    got = run_ranks(pool_worker, 2, tmp_path, feats, COUNTS,
                    ("float32", "bfloat16"), other)
    for (n, dt), w in want.items():
        g = got[(n, dt)]
        if dt == "float32":
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6,
                                       err_msg=str(n))
        else:
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=2 ** -6 * np.abs(w).max(),
                                       err_msg=str(n))
    # at 30 valid frames the second rank's 50 frames add nothing
    assert not got[(30, "float32")][30:100].any()
    np.testing.assert_allclose(got["other"], want_other, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(
        got["other"], spatio_temporal_pool(torch.from_numpy(other),
                                           out_dtype=torch.float32).numpy(),
        rtol=1e-6, atol=1e-7)
    set_pooling_mesh(object())  # what a session's model_init registers
    driver.stop()
    assert get_pooling_mesh() is None
