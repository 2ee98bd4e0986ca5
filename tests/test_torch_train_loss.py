"""Port parity: the training loss (models/video_llava.forward with
labels: the video splice, the cacheless LLaMA with remat, the shifted
masked cross-entropy) and its gradients for the projector and
embed_tokens, against jax.value_and_grad of the JAX package's loss_fn."""

import numpy as np
import jax

from video_llava_tpu.train.train_step import loss_fn as jax_loss_fn
from torch_train_pair import (
    as_jax,
    as_torch,
    batch_np,
    flat,
    jax_params,
    port_model,
    tiny_cfg,
)


def test_loss_and_trainable_gradients_match_jax():
    """For a linear and an mlp2x_gelu projector: the loss within 1e-5
    relative and the projector and embed_tokens gradients within 1e-5 of
    each tensor's max |ref| (f32 on both sides; only summation order
    differs). Rows that are not targets and tokens that appear in no row
    get exactly zero embedding gradient on both sides."""
    for projector_type in ("linear", "mlp2x_gelu"):
        cfg = tiny_cfg(projector_type=projector_type)
        params = jax_params(cfg)
        batch = batch_np(cfg)
        want_loss, want_grads = jax.value_and_grad(jax_loss_fn)(
            params, cfg, as_jax(batch))
        want = flat(want_grads)

        model = port_model(params, cfg)
        names = [n for n, _ in model.named_parameters()
                 if n.startswith("projector") or "embed_tokens" in n]
        assert len(names) == (3 if projector_type == "linear" else 5)
        for n, p in model.named_parameters():
            p.requires_grad_(n in names)
        t = as_torch(batch)
        _, loss = model(t["input_ids"], t["video_features"],
                        labels=t["labels"], remat=True)
        loss.backward()
        np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
        params_t = dict(model.named_parameters())
        for n in names:
            got, ref = params_t[n].grad.numpy(), want[n]
            scale = np.abs(ref).max()
            assert scale > 0, n
            np.testing.assert_allclose(got, ref, atol=1e-5 * scale, rtol=0,
                                       err_msg=f"{projector_type} {n}")
        unseen = np.setdiff1d(np.arange(cfg.llm.vocab_size),
                              batch["input_ids"])
        g = params_t["llm.embed_tokens.weight"].grad.numpy()
        assert not g[unseen].any() and not want[
            "llm.embed_tokens.weight"][unseen].any()
