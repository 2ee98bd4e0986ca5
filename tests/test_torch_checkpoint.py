"""The port's checkpoints (engine/checkpoint.py): the whole train state
saved, found and restored; the projector export against the JAX
package's export_projector on the same parameters."""

import os

import numpy as np
import torch

from video_llava_tpu.engine.checkpoint import (
    export_projector as jax_export_projector,
)
from video_llava_tpu_torch.engine.checkpoint import (
    export_projector,
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from video_llava_tpu_torch.train import train_step as tts
from torch_train_pair import (
    as_torch,
    batch_np,
    jax_params,
    port_model,
    tiny_cfg,
)


def test_save_latest_restore_and_export(tmp_path):
    """Two steps, saved at step 2 (twice: a re-save replaces) and at 10;
    latest_checkpoint picks 10 over 2 (numerically, not by name) and
    ignores other entries; restoring step 2 into a fresh state gives the
    parameters, moments, count and step bit-equal, and the next step from
    the restored state equals the next step from the original. Then
    export_projector's .bin holds the same keys, shapes and f32 values
    as the JAX package's export, for a linear and an mlp2x_gelu
    projector, with and without embed_tokens."""
    cfg = tiny_cfg()
    params = jax_params(cfg)
    batch = as_torch(batch_np(cfg))
    ckpt = str(tmp_path / "ckpt")
    assert latest_checkpoint(ckpt) is None

    def fresh():
        model = port_model(params, cfg)
        tx = tts.make_optimizer(1e-2, warmup_steps=0, total_steps=10)
        names = tts.trainable_mask(model)
        return tts.init_train_state(model, tx, names), tts.make_train_step(tx)

    state, step = fresh()
    for _ in range(2):
        state, _ = step(state, batch)
    save_checkpoint(ckpt, 2, state)
    path = save_checkpoint(ckpt, 2, state)
    assert os.path.basename(path) == "checkpoint-2"
    os.makedirs(os.path.join(ckpt, "checkpoint-x"))
    os.makedirs(os.path.join(ckpt, "mm_projector"))
    assert latest_checkpoint(ckpt) == os.path.join(ckpt, "checkpoint-2")
    assert sorted(os.listdir(ckpt)) == ["checkpoint-2", "checkpoint-x",
                                        "mm_projector"]

    restored, step2 = fresh()
    restored = restore_checkpoint(path, restored)
    assert restored.step == 2 and restored.opt_state["count"] == 2
    want = dict(state.model.named_parameters())
    for n, p in restored.model.named_parameters():
        assert p.requires_grad == want[n].requires_grad, n
        assert torch.equal(p, want[n]), n
    for m in ("mu", "nu"):
        for n, t in state.opt_state[m].items():
            assert torch.equal(restored.opt_state[m][n], t), (m, n)
    state, m1 = step(state, batch)
    restored, m2 = step2(restored, batch)
    assert torch.equal(m1["loss"], m2["loss"])
    for (n, a), b in zip(state.model.named_parameters(),
                         restored.model.parameters()):
        assert torch.equal(a, b), n
    save_checkpoint(ckpt, 10, state)
    assert latest_checkpoint(ckpt) == os.path.join(ckpt, "checkpoint-10")

    for projector_type in ("linear", "mlp2x_gelu"):
        cfg = tiny_cfg(projector_type=projector_type)
        params = jax_params(cfg, seed=3)
        model = port_model(params, cfg)
        for emb in (True, False):
            ours, theirs = (str(tmp_path / f"{who}-{projector_type}-{emb}.bin")
                            for who in ("port", "jax"))
            export_projector(model, ours, include_embeddings=emb)
            jax_export_projector(params, theirs, include_embeddings=emb)
            got, want = torch.load(ours), torch.load(theirs)
            assert sorted(got) == sorted(want)
            assert ("model.embed_tokens.weight" in got) == emb
            for key, ref in want.items():
                assert got[key].dtype == ref.dtype == torch.float32, key
                np.testing.assert_array_equal(got[key].numpy(), ref.numpy(),
                                              err_msg=key)
