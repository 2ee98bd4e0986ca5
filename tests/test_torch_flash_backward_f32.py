"""Kernel 8's f32 body and head dims past 256, on the CPU. The plain
backward (flash_backward_plain, the f32 SIMT body's plain version)
against the JAX package's _flash_backward in Pallas interpret mode on
f32 inputs (each fed its own forward's out and lse), at Whisper base's
head layout and a ragged causal GQA pair: dq, dk, dv within 1e-5
absolute (outputs of
magnitude < 8; f32 on both sides, sums in another order), and in q's
dtype. Then the wrappers' padding past d 256 (padded_head_dim: the next
multiple of 128) around the plain forward against the JAX package's
Pallas forward in interpret mode at d 320, out and lse within 1e-5, and
the padded plain backward against the unpadded one (1e-5); on meta
tensors, which stand in for the card, f32 operands of
flash_backward reach the f32 body's entries and d 320 passes the
wrapper's checks (the kernels themselves: tests/test_torch_kernels_gpu.py)."""

import numpy as np
import jax.numpy as jnp
import torch

from video_llava_tpu.ops.attention import _flash_backward, _flash_forward
from video_llava_tpu_torch.ops import attention, cuda_lib

# (b, sq, skv, h, h_kv, d, causal, block)
CASES = [(1, 300, 300, 8, 8, 64, False, 128),
         (2, 100, 130, 8, 2, 128, True, 64)]


def test_f32_backward_and_wide_head_dims_match_pallas(monkeypatch):
    rng = np.random.default_rng(5)
    for b, sq, skv, h, h_kv, d, causal, block in CASES:
        q, g = (rng.normal(size=(b, sq, h, d)).astype(np.float32)
                for _ in range(2))
        k, v = (rng.normal(size=(b, skv, h_kv, d)).astype(np.float32)
                for _ in range(2))
        qt, kt, vt, gt = map(torch.from_numpy, (q, k, v, g))
        out, lse = attention.flash_forward_plain(qt, kt, vt, causal)
        jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
        # each side's backward is fed its own forward's out and lse
        jout, jlse = _flash_forward(jq, jk, jv, causal, None, block, block,
                                    True)
        want = _flash_backward(jq, jk, jv, jout, jlse, jnp.asarray(g),
                               causal, None, block, block, True)
        got = attention.flash_backward_plain(qt, kt, vt, out, lse, gt,
                                             causal)
        case = (b, sq, skv, h, h_kv, d, causal)
        for a, w in zip(got, want):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=1e-5,
                                       rtol=0, err_msg=str(case))

    # past d 256: the next multiple of 128, with the unpadded d's scale
    assert [attention.padded_head_dim(d) for d in (256, 264, 320, 384,
                                                   512, 520)] == [
        256, 384, 384, 384, 512, 640]
    b, sq, skv, h, h_kv, d = 1, 40, 56, 4, 2, 320
    q = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, skv, h_kv, d)).astype(np.float32)
            for _ in range(2))
    want, want_lse = _flash_forward(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), True, None, 64, 64, True)
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    got, lse = attention.flash_forward_padded(attention.flash_forward_plain,
                                              qt, kt, vt, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(
        lse.numpy(), np.asarray(want_lse)[:, :sq, 0].reshape(b, h, sq),
        atol=1e-5, rtol=0)
    gt = torch.from_numpy(rng.normal(size=(b, sq, h, d)).astype(np.float32))
    padded = attention.flash_backward_padded(
        attention.flash_backward_plain, qt, kt, vt, got, lse, gt, True)
    ref = attention.flash_backward_plain(qt, kt, vt, got, lse, gt, True)
    for a, r in zip(padded, ref):
        assert a.shape == r.shape and a.is_contiguous()
        np.testing.assert_allclose(a.numpy(), r.numpy(), atol=1e-5, rtol=0)

    # the wrappers' dispatch on meta tensors: f32 to the f32 entries,
    # d 320 padded to 384 and taken
    launched = []
    monkeypatch.setattr(cuda_lib, "launch",
                        lambda kernel, entry, *a: launched.append(entry))
    monkeypatch.setattr(cuda_lib, "require", lambda *a, **kw: None)
    for dt, d in ((torch.float32, 64), (torch.bfloat16, 320)):
        m = torch.empty(1, 70, 4, d, dtype=dt, device="meta")
        ml = torch.empty(1, 4, 70, device="meta")
        attention.flash_backward(m, m, m, m, ml, m, True)
        attention.flash_forward(m, m, m, True)
    assert launched == ["vlt_flash_bwd_dq_f32", "vlt_flash_bwd_dkv_f32",
                        "vlt_flash_fwd_f32", "vlt_flash_bwd_dq",
                        "vlt_flash_bwd_dkv", "vlt_flash_fwd"]
