"""models/swin.py against the JAX package's Swin on the tiny config's
parameters carried across by engine/convert.tree_from_jax: every stage's
feature map (forward_features) and the pooled features (forward_pooled),
within 1e-4 absolute (f32, LayerNorm'd activations of order 1). The
inputs include maps the window does not divide (padding), odd maps at
the patch merge (zero padding) and a map smaller than the window (the
window shrinks), as the 800 px detector's 200/100/50/25-wide maps need."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import torch

from video_llava_tpu.models import swin as jswin
from video_llava_tpu_torch.models import swin as tswin
from torch_grounding_pair import META, to_port


def test_swin_features_match_jax():
    cfg = jswin.SwinConfig.tiny_test()
    tcfg = tswin.SwinConfig.tiny_test()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
    params = jswin.init_params(jax.random.PRNGKey(0), cfg)
    tp = to_port(params, tswin.init_params(META, tcfg))
    rng = np.random.default_rng(0)
    # 72 x 88: maps 18 x 22 (padded) then 9 x 11 (odd merge, padded);
    # 24 x 40: 6 x 10 then 3 x 5 (the window shrinks to 3)
    for h, w in ((72, 88), (24, 40)):
        px = rng.standard_normal((2, h, w, 3)).astype(np.float32)
        want = jswin.forward_features(params, jnp.asarray(px), cfg)
        got = tswin.forward_features(tp, torch.from_numpy(px), tcfg)
        assert len(got) == len(want) == cfg.num_stages
        for g, j in zip(got, want):
            assert tuple(g.shape) == j.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=1e-4)
        np.testing.assert_allclose(
            tswin.forward_pooled(tp, torch.from_numpy(px), tcfg).numpy(),
            np.asarray(jswin.forward_pooled(params, jnp.asarray(px), cfg)),
            atol=1e-4)
