"""Port: kernel 7's plain forward under an explicit mask
(flash_forward_masked, which chip_smoke.py's planted forward fault
uses) against the JAX package's _flash_forward in Pallas interpret
mode, and a dropped diagonal tile seen by the per-(row, head) check."""

import numpy as np
import jax.numpy as jnp
import torch

from video_llava_tpu.ops.attention import _flash_forward
from video_llava_tpu_torch.ops.attention import (
    flash_forward_masked,
    flash_mask,
)


def test_flash_forward_masked_matches_pallas_and_sees_a_dropped_tile():
    """Under flash_mask, out and lse as the Pallas forward's (f32, 1e-5:
    the same math in another summation order), causal with sq < skv and
    GQA 4/2. With the diagonal key tile of query tile 1 (128-row tiles)
    dropped from the mask, only that tile's rows move, and by more than
    2^-6 of a (row, head)'s max |ref|: the limit chip_smoke.py holds the
    kernel to."""
    rng = np.random.default_rng(4)
    b, sq, skv, h, h_kv, d = 1, 300, 320, 4, 2, 32
    q = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    k = rng.normal(size=(b, skv, h_kv, d)).astype(np.float32)
    v = rng.normal(size=(b, skv, h_kv, d)).astype(np.float32)
    want, want_lse = _flash_forward(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), True, None, 64, 64, True)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    mask = flash_mask(sq, skv, True, "cpu")
    got, lse = flash_forward_masked(qt, kt, vt, mask, d ** -0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    want_lse = np.asarray(want_lse)[:, :sq, 0].reshape(b, h, sq)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=1e-5, rtol=1e-5)

    dropped = mask.clone()
    dropped[128:256, 128:256] = False
    bad, _ = flash_forward_masked(qt, kt, vt, dropped, d ** -0.5)
    rel = ((bad - got).abs().amax(-1) / got.abs().amax(-1))[0]  # (sq, h)
    moved = rel.amax(-1) > 0
    assert moved[128:256].all() and not moved[:128].any() \
        and not moved[256:].any()
    assert rel.max().item() > 2 ** -6
