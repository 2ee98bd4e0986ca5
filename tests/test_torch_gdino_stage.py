"""The `stage` truncation of models/grounding_dino._forward_device
against the JAX package's, on the tiny GroundingDINO (tests/
torch_grounding_pair.dino_pair): for each of 'text', 'backbone',
'encoder', 'two_stage' and None both outputs within the GroundingDINO
parity tolerance of tests/test_torch_grounding_dino.py (features and
logits 1e-4 where finite, -inf where JAX has -inf; boxes and reference
points 1e-5); stage=None equal to the shipped forward bit for bit; and
profile_gdino.run's stage prefixes on the tiny detector: every key, the
deltas summing to the whole forward, and its forward output equal to
GroundingDinoDetector's forward on the same inputs. run() times on a
fake clock (tests/torch_fake_clock.py) where the k-th stage prefix
costs k + 1 units of 2^-8 s, so every time it prints is a known value."""

import json

import jax.numpy as jnp
import numpy as np
import torch

from torch_fake_clock import FakeClock
from torch_grounding_pair import dino_pair
from torch_xmem_pair import one_torch_thread
from video_llava_tpu.models import grounding_dino as jgd
from video_llava_tpu_torch.models import grounding_dino as tgd
from video_llava_tpu_torch.scripts import profile_gdino
from video_llava_tpu_torch.utils import timing


@one_torch_thread()
def test_gdino_stages_match_jax(monkeypatch):
    jp, tp = dino_pair()
    cfg, tcfg = (jgd.GroundingDinoConfig.tiny_test(),
                 tgd.GroundingDinoConfig.tiny_test())
    rng = np.random.default_rng(0)
    px = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    ids = np.asarray([[101, 5, 6, 1012, 7, 8, 9, 1012, 102]] * 2)
    mask = np.ones_like(ids)
    self_mask, pos = jgd.generate_text_masks(ids)
    host = (ids, mask == 0, self_mask, pos, mask == 1)
    tol = {"text": (1e-4, 1e-4), "backbone": (1e-4, 1e-4),
           "encoder": (1e-4, 1e-4), "two_stage": (1e-5, 1e-5),
           None: (1e-4, 1e-5)}
    for stage in profile_gdino.STAGES:
        want = jgd._forward_device(jp, cfg, jnp.asarray(px),
                                   *map(jnp.asarray, host), stage=stage)
        got = tgd._forward_device(
            tp, tcfg, torch.from_numpy(px),
            *(torch.as_tensor(np.array(a)) for a in host), stage=stage)
        for g, w, atol in zip(got, want, tol[stage]):
            g, w = g.numpy(), np.asarray(w)
            assert g.shape == w.shape, stage
            fin = np.isfinite(w)
            np.testing.assert_array_equal(np.isfinite(g), fin)
            np.testing.assert_allclose(g[fin], w[fin], atol=atol,
                                       err_msg=str(stage))
    shipped = tgd.forward(tp, tcfg, torch.from_numpy(px), ids)
    for a, b in zip(got, shipped):
        assert torch.equal(a, b)

    det = tgd.GroundingDinoDetector(tp, tcfg, tgd.char_tokenize,
                                    image_size=64)
    clock = FakeClock()
    monkeypatch.setattr(timing, "time", clock)
    unit = 2.0 ** -8
    real_forward = tgd._forward_device

    def timed_forward(*a, stage=None, **kw):
        clock.sleep(unit * (profile_gdino.STAGES.index(stage) + 1))
        return real_forward(*a, stage=stage, **kw)

    monkeypatch.setattr(tgd, "_forward_device", timed_forward)
    lines = []
    out, full = profile_gdino.run(det, batch=2, iters=1,
                                  print_fn=lines.append)
    assert json.loads(lines[-1]) == out and len(lines) == 6
    for k, st in enumerate(("text", "backbone", "encoder", "two_stage",
                            "full")):
        assert out[f"cum_{st}_ms"] >= 0 and f"delta_{st}_ms" in out
        assert out[f"cum_{st}_ms"] == round(unit * (k + 1) * 1e3, 1)
        assert out[f"delta_{st}_ms"] == round(unit * 1e3, 1)
    # both rounded to 0.1 ms from the unrounded time
    assert abs(out["per_frame_ms"] - out["cum_full_ms"] / 2) <= 0.1
    assert out["per_frame_ms"] == round(unit * 5 * 1e3 / 2, 1)
    args = profile_gdino.device_args(det, 2)
    ref = tgd.forward(tp, tcfg, args[0], args[1].numpy())
    for a, b in zip(full, ref):
        assert torch.equal(a, b)
