"""Port parity: three optimizer steps of train/train_step.make_train_step
(AdamW under a warmup-cosine schedule, projector+embed tuning) against
the JAX package's jitted step with optax on the same parameters and
batches."""

import numpy as np
import torch

from video_llava_tpu.train import train_step as jts
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

LR, WD, WARMUP, TOTAL = 1e-2, 0.05, 1, 3


def test_three_adamw_steps_match_optax():
    """Warmup 1 of 3 steps: step 0 runs at lr 0 (the schedule is read at
    the count before the update) and moves nothing but the moments; steps
    1 and 2 at the peak and half of it. Per step, loss and grad norm
    within 1e-5 relative. After the steps, every trainable parameter
    within 1e-6 + 1e-4 relative of optax's: Adam divides each gradient by
    its own running RMS, so an f32 summation-order difference of a
    near-zero gradient (1e-5 of its size) becomes 1e-5 of an update of
    size lr, i.e. ~1e-7 absolute here. Frozen parameters are bit-equal
    to their initial values, and the optimizer's count is 3."""
    cfg = tiny_cfg()
    params = jax_params(cfg)
    init = flat(params)
    batches = [batch_np(cfg, seed=i) for i in range(3)]

    mask = jts.trainable_mask(params, "projector+embed")
    jtx = jts.make_optimizer(LR, WD, warmup_steps=WARMUP, total_steps=TOTAL)
    jstate = jts.init_train_state(params, jtx, mask)
    jstep = jts.make_train_step(cfg, jtx, mask=mask, donate=False)

    model = port_model(params, cfg)
    names = tts.trainable_mask(model, "projector+embed")
    assert names == ["projector.layers.0.kernel", "projector.layers.0.bias",
                     "llm.embed_tokens.weight"]
    ttx = tts.make_optimizer(LR, WD, warmup_steps=WARMUP, total_steps=TOTAL)
    tstate = tts.init_train_state(model, ttx, names)
    tstep = tts.make_train_step(ttx)

    for i, batch in enumerate(batches):
        jstate, jm = jstep(jstate, as_jax(batch))
        tstate, tm = tstep(tstate, as_torch(batch))
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-5, err_msg=f"step {i} {key}")
        if i == 0:  # lr 0: nothing moved yet
            for n in names:
                np.testing.assert_array_equal(
                    dict(model.named_parameters())[n].detach().numpy(),
                    init[n])
    assert tstate.step == int(jstate.step) == 3
    assert tstate.opt_state["count"] == 3

    want = flat(jstate.params)
    for n, p in model.named_parameters():
        got = p.detach().numpy()
        if n in names:
            assert not np.array_equal(got, init[n]), n
            np.testing.assert_allclose(got, want[n], rtol=1e-4, atol=1e-6,
                                       err_msg=n)
        else:
            assert not p.requires_grad and p.grad is None, n
            np.testing.assert_array_equal(got, init[n], err_msg=n)
    assert torch.is_tensor(tm["loss"]) and torch.isfinite(tm["loss"])
