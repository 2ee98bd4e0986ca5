"""Data parallel x tensor parallel training: two projector+embed steps of
the port's make_train_step over 4 gloo ranks on the CPU (make_mesh(2, 2):
each data rank 2 of the 4 rows, each model rank half the heads, FFN and
vocab) against the JAX package's jitted make_train_step on its (2, 2)
virtual mesh, on the same f32 tree and batches (tests/torch_train_pair:
row i masks its first 30 + 3 i labels, so the two data shards hold 65
and 53 targets). Per step the loss and the grad norm within rtol 1e-5,
and the projector and embed_tokens (gathered from the ranks) within
rtol 1e-4, atol 1e-6 (Adam divides each gradient by its own RMS, so an
f32 summation-order difference of a near-zero gradient shows at 1e-5 of
an update of size lr, as in tests/test_torch_train_step.py). The
ranks' mean of their own means would miss JAX's loss by more than the
tolerance, which the test checks too."""

import jax
import numpy as np
from jax.sharding import NamedSharding

from torch_dp_pair import train_cfg, train_worker
from torch_tp_pair import run_ranks
from torch_train_pair import as_jax, batch_np, flat, jax_params, tiny_cfg
from video_llava_tpu.parallel import make_mesh, shard_params
from video_llava_tpu.parallel import videollava_param_specs
from video_llava_tpu.parallel.sharding import batch_spec
from video_llava_tpu.train import train_step as jts

OPT = (1e-2, 0.05, 0, 3)  # lr, weight decay, warmup steps, total steps
WATCH = ("projector.layers.0.kernel", "projector.layers.0.bias",
         "llm.embed_tokens.weight")


def test_dp_tp_steps_match_jax(tmp_path):
    cfg = tiny_cfg()
    params = jax_params(cfg)
    batches = [batch_np(cfg, seed=i) for i in range(2)]
    mesh = make_mesh(2, 2)
    sharded = shard_params(params, videollava_param_specs(params), mesh)
    mask = jts.trainable_mask(sharded, "projector+embed")
    tx = jts.make_optimizer(OPT[0], OPT[1], warmup_steps=OPT[2],
                            total_steps=OPT[3])
    state = jts.init_train_state(sharded, tx, mask)
    step = jts.make_train_step(cfg, tx, mask=mask, donate=False)
    want = []
    for b in batches:
        state, m = step(state, {
            k: jax.device_put(v, NamedSharding(mesh, batch_spec(v.ndim)))
            for k, v in as_jax(b).items()})
        want.append((float(m["loss"]), float(m["grad_norm"]),
                     flat(state.params)))

    # a mean of the data shards' own means is not the global mean
    loss_of = jax.jit(lambda p, b: jts.loss_fn(p, cfg, b))
    halves = [float(loss_of(params, as_jax(
        {k: v[2 * d:2 * d + 2] for k, v in batches[0].items()})))
        for d in range(2)]
    assert abs(np.mean(halves) - want[0][0]) > 1e-4 * abs(want[0][0])

    out = run_ranks(train_worker, 4, tmp_path,
                    jax.tree.map(np.asarray, params), train_cfg(), batches,
                    (2, 2), "projector+embed", False, OPT, WATCH)
    assert out["trainable"] == list(WATCH)
    for i, (got, (loss, gnorm, tree)) in enumerate(zip(out["steps"], want)):
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-5,
                                   err_msg=f"step {i}")
        np.testing.assert_allclose(got["grad_norm"], gnorm, rtol=1e-5,
                                   err_msg=f"step {i}")
        for n in WATCH:
            np.testing.assert_allclose(got["params"][n], tree[n], rtol=1e-4,
                                       atol=1e-6, err_msg=f"step {i} {n}")
