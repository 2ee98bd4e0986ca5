"""Gradient accumulation in the port's train step: the strided,
token-weighted f32 microbatch average equals the full batch's step, and
the JAX package's accumulated step (tests/test_grad_accum.py's
property, on the port)."""

import numpy as np
import optax
import torch

from video_llava_tpu.train import train_step as jts
from video_llava_tpu_torch.constants import IGNORE_INDEX
from video_llava_tpu_torch.train import train_step as tts
from torch_train_pair import (
    as_jax,
    as_torch,
    batch_np,
    flat,
    jax_params,
    port_model,
    tiny_cfg,
)

LR = 1e-1


class _Sgd:
    """p -= LR * g (optax.sgd): an update proportional to the gradient,
    so the parameters after one step show the gradient itself."""

    def init(self, params):
        return {"count": 0, "mu": dict.fromkeys(params)}

    @torch.no_grad()
    def update(self, grads, state, params):
        for n, p in params.items():
            p.sub_(LR * grads[n])
        return {**state, "count": state["count"] + 1}


def _step(cfg, params, batch, grad_accum, mode="projector+embed"):
    model = port_model(params, cfg)
    names = tts.trainable_mask(model, mode)
    tx = _Sgd()
    state = tts.init_train_state(model, tx, names)
    state, metrics = tts.make_train_step(tx, grad_accum)(state,
                                                         as_torch(batch))
    return model, names, metrics


def test_accumulated_step_matches_full_batch_and_jax():
    """8 rows whose target counts differ (a 2-way strided split gives
    the microbatches 100 and 88 targets), grad_accum 2 and 4 against the
    full batch, for projector+embed and for full tuning: loss within
    1e-5 relative, parameters within 2e-6 + 2e-5 relative (the bounds of
    tests/test_grad_accum.py), grad norms within 1e-5. Then grad_accum
    2 against the JAX package's accumulated step to the same bounds."""
    cfg = tiny_cfg()
    params = jax_params(cfg)
    batch = batch_np(cfg, b=8)
    counts = [(batch["labels"][a::2, 1:] != IGNORE_INDEX).sum()
              for a in range(2)]
    assert counts[0] != counts[1]
    for mode in ("projector+embed", "full"):
        full, names, m_full = _step(cfg, params, batch, 1, mode)
        full_p = dict(full.named_parameters())
        for accum in (2, 4):
            model, _, m = _step(cfg, params, batch, accum, mode)
            for key in ("loss", "grad_norm"):
                np.testing.assert_allclose(float(m[key]), float(m_full[key]),
                                           rtol=1e-5, err_msg=key)
            for n, p in model.named_parameters():
                np.testing.assert_allclose(
                    p.detach().numpy(), full_p[n].detach().numpy(),
                    atol=2e-6, rtol=2e-5, err_msg=f"{mode} {accum} {n}")

    mask = jts.trainable_mask(params, "projector+embed")
    tx = optax.sgd(LR)
    jstep = jts.make_train_step(cfg, tx, mask=mask, donate=False,
                                grad_accum=2)
    jstate, jm = jstep(jts.init_train_state(params, tx, mask),
                       as_jax(batch))
    model, names, m = _step(cfg, params, batch, 2)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-5)
    want = flat(jstate.params)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n], atol=2e-6,
                                   rtol=2e-5, err_msg=n)
