"""FSDP and the frozen int8 LLM under a mesh, against the JAX package.

--tune_mode full with FSDP: the port's step over 4 gloo ranks on the CPU
(make_mesh(2, 2), shard_params(fsdp=True): the free dim of every big
matched kernel and the LLM's layer norms on 'data', gathered at use, the
gradient summed over 'data' and sliced in the gather's backward pass)
against JAX's jitted step on its (2, 2) virtual mesh with
videollava_param_specs(fsdp=True), on the same f32 tree and batches
(rows with different target counts, tests/torch_train_pair): per step
the loss and grad norm within rtol 1e-5, and the watched parameters
(the projector, embed_tokens, lm_head, a layer's wq and down and its
norms, the final norm, and a CLIP kernel that the loss does not reach,
moved by the weight decay alone) element by element within rtol 1e-4,
atol 1e-6 but for at most 0.1% of a tensor's elements, and those within
2 lr: Adam's first steps move each element by about lr times the sign of
its gradient, so an element whose gradient is near zero (its f32 sum
runs in another order on another layout) can move by any fraction of lr
either way. JAX's own (2, 2) FSDP step and its one-device step on this
tree part so too (layers.1.down by 1.6e-4 after the first step).

The frozen int8 LLM (JAX tests/test_sharding.py
test_train_step_int8_frozen_llm, with quantize_params' default min_size,
as --llm_weights int8 quantizes, at width 256 where every LLM kernel
reaches it; embed_tokens kept f32) on make_mesh(2, 1), data parallel,
against JAX's step on the whole batch: the loss and grad norm as above,
the trainable projector and embed_tokens by the same element rule (the
port's one-process int8 step parts from JAX's by 2.8e-4 on a projector
element already), and the int8 leaves unmoved."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding

from torch_dp_pair import train_cfg, train_worker
from torch_tp_pair import run_ranks
from torch_train_pair import as_jax, batch_np, flat, tiny_cfg
from video_llava_tpu.models import video_llava as jvl
from video_llava_tpu.ops.quant import quantize_params
from video_llava_tpu.parallel import make_mesh, shard_params
from video_llava_tpu.parallel import videollava_param_specs
from video_llava_tpu.parallel.sharding import batch_spec
from video_llava_tpu.train import train_step as jts

OPT = (1e-2, 0.05, 0, 3)  # lr, weight decay, warmup steps, total steps
WATCH_FULL = ("projector.layers.0.kernel", "llm.embed_tokens.weight",
              "llm.lm_head.kernel", "llm.layers.0.wq.kernel",
              "llm.layers.1.down.kernel", "llm.layers.1.input_norm.scale",
              "llm.layers.0.post_norm.scale", "llm.final_norm.scale",
              "vision.layers.0.fc1.kernel")
WATCH_INT8 = ("projector.layers.0.kernel", "projector.layers.0.bias",
              "llm.embed_tokens.weight", "llm.layers.0.wq.kernel.qvalues")


def _jax_steps(cfg, params, batches, mode, mesh_shape, fsdp):
    mask = jts.trainable_mask(params, mode)
    if mesh_shape:
        mesh = make_mesh(*mesh_shape)
        params = shard_params(params, videollava_param_specs(params, fsdp),
                              mesh)
    tx = jts.make_optimizer(OPT[0], OPT[1], warmup_steps=OPT[2],
                            total_steps=OPT[3])
    state = jts.init_train_state(params, tx, mask)
    step = jts.make_train_step(cfg, tx, mask=mask, donate=False)
    out = []
    for b in batches:
        b = as_jax(b)
        if mesh_shape:
            b = {k: jax.device_put(v, NamedSharding(mesh,
                                                    batch_spec(v.ndim)))
                 for k, v in b.items()}
        state, m = step(state, b)
        out.append((float(m["loss"]), float(m["grad_norm"]),
                    flat(state.params)))
    return out


def _check(got, want, watch):
    lr = OPT[0]
    for i, (g, (loss, gnorm, tree)) in enumerate(zip(got["steps"], want)):
        np.testing.assert_allclose(g["loss"], loss, rtol=1e-5,
                                   err_msg=f"step {i}")
        np.testing.assert_allclose(g["grad_norm"], gnorm, rtol=1e-5,
                                   err_msg=f"step {i}")
        for n in watch:
            a, b = g["params"][n], tree[n]
            off = ~np.isclose(a, b, rtol=1e-4, atol=1e-6)
            assert off.mean() <= 1e-3, (i, n, int(off.sum()))
            np.testing.assert_allclose(a, b, rtol=0, atol=2 * lr,
                                       err_msg=f"step {i} {n}")


def test_fsdp_full_and_int8_frozen_steps_match_jax(tmp_path):
    cfg = tiny_cfg()
    params = jax.jit(lambda k: jvl.init_params(k, cfg, jnp.float32))(
        jax.random.PRNGKey(0))
    init = flat(params)
    batches = [batch_np(cfg, seed=i) for i in range(2)]
    tree = jax.tree.map(np.asarray, params)

    # the ranks first: they run while JAX's CPU threads are still idle
    got = run_ranks(train_worker, 4, tmp_path, tree, train_cfg(), batches,
                    (2, 2), "full", True, OPT, WATCH_FULL)
    want = _jax_steps(cfg, params, batches, "full", (2, 2), True)
    _check(got, want, WATCH_FULL)
    assert not np.array_equal(got["steps"][-1]["params"][
        "vision.layers.0.fc1.kernel"], init["vision.layers.0.fc1.kernel"])

    wide = dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, hidden_size=256, intermediate_size=512, head_dim=64))
    params = jax.jit(lambda k: jvl.init_params(k, wide, jnp.float32))(
        jax.random.PRNGKey(0))
    qparams = dict(params, llm=jax.jit(lambda p: quantize_params(
        p, skip_keys=("class_embedding", "position_embedding",
                      "embed_tokens")))(params["llm"]))
    assert "qvalues" in qparams["llm"]["layers"]["wq"]["kernel"]
    got = run_ranks(train_worker, 2, tmp_path,
                    jax.tree.map(np.asarray, qparams),
                    train_cfg(width=256), batches, (2, 1),
                    "projector+embed", False, OPT, WATCH_INT8)
    want = _jax_steps(wide, qparams, batches, "projector+embed", None, False)
    assert got["trainable"] == list(WATCH_INT8[:3])
    _check(got, want, WATCH_INT8)
    np.testing.assert_array_equal(
        got["steps"][-1]["params"]["llm.layers.0.wq.kernel.qvalues"],
        flat(qparams)["llm.layers.0.wq.kernel.qvalues"])
