"""scripts/weight_tools.py against the JAX package's, on the JAX test's
case (tests/test_scripts.py test_delta_roundtrip: a shared layer, an
embedding resized from 10 to 12 rows, a projector key the base lacks):
the port's f32 deltas equal the JAX package's exactly, and so does
apply_delta's result (within 1e-6 of the target, as the JAX test holds
it); in bf16 (the stored dtype, as the reference subtracts) the round
trip is within 2^-7 * (|target| + |base|) elementwise (two roundings
to bf16's 8-bit significand, each within 2^-8 of its value), the rows the base lacks and the projector
exactly. The CLI's make-delta / apply-delta / consolidate through .npz,
.safetensors and .bin: every file read back bit-equal to what was
written; a port-written .safetensors (f32, bf16, f16, int64) read back
bit-equal by the `safetensors` library; .npz of a bf16 tensor raises
naming it."""

import numpy as np
import pytest
import torch
from safetensors.torch import load_file

from video_llava_tpu.scripts import weight_tools as jwt
from video_llava_tpu_torch.engine import weights
from video_llava_tpu_torch.scripts import weight_tools as twt


def _case():
    rng = np.random.default_rng(0)
    base = {
        "model.layers.0.w": rng.normal(size=(4, 4)).astype(np.float32),
        "model.embed_tokens.weight": rng.normal(size=(10, 4)).astype(
            np.float32),
    }
    target = {
        "model.layers.0.w": rng.normal(size=(4, 4)).astype(np.float32),
        "model.embed_tokens.weight": rng.normal(size=(12, 4)).astype(
            np.float32),
        "model.mm_projector.weight": rng.normal(size=(4, 4)).astype(
            np.float32),
    }
    return base, target


def _t(sd, dtype=None):
    return {k: torch.from_numpy(v.copy()).to(dtype or torch.float32)
            for k, v in sd.items()}


def test_weight_tools_match_jax(tmp_path):
    base, target = _case()
    want = jwt.make_delta(base, {k: v.copy() for k, v in target.items()})
    got = twt.make_delta(_t(base), _t(target))
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    want_back = jwt.apply_delta(base, want)
    back = twt.apply_delta(_t(base), got)
    for k in target:
        np.testing.assert_array_equal(back[k].numpy(), want_back[k])
        np.testing.assert_allclose(back[k].numpy(), target[k], rtol=1e-6,
                                   atol=1e-6)

    bb, bt = _t(base, torch.bfloat16), _t(target, torch.bfloat16)
    back = twt.apply_delta(bb, twt.make_delta(bb, bt))
    for k, t in bt.items():
        assert back[k].dtype == torch.bfloat16
        err = (back[k].float() - t.float()).abs()
        b = bb.get(k)
        if b is None:
            assert torch.equal(back[k], t)
            continue
        mag = t.float().abs()
        mag[:b.shape[0], :b.shape[1]] += b.float().abs()
        assert (err <= 2.0 ** -7 * mag).all(), k
        if k == "model.embed_tokens.weight":
            assert torch.equal(back[k][10:], t[10:])

    for ext in (".npz", ".safetensors", ".bin"):
        bpath, tpath = tmp_path / f"b{ext}", tmp_path / f"t{ext}"
        twt._save(str(bpath), _t(base))
        twt._save(str(tpath), _t(target))
        d, out, cons = (tmp_path / f"{n}{ext}" for n in ("d", "o", "c"))
        twt.main(["make-delta", "--base", str(bpath), "--target", str(tpath),
                  "--delta", str(d)])
        twt.main(["apply-delta", "--base", str(bpath), "--delta", str(d),
                  "--target", str(out)])
        twt.main(["consolidate", "--src", str(out), "--dst", str(cons)])
        for path, sd in ((d, got), (out, twt.apply_delta(_t(base), got)),
                         (cons, twt.apply_delta(_t(base), got))):
            read = twt._load(str(path))
            assert list(read) == list(sd), (ext, path)
            for k in sd:
                assert torch.equal(read[k], sd[k]), (ext, path, k)

    rng = np.random.default_rng(1)
    mixed = {"a.f32": torch.from_numpy(rng.normal(size=(3, 5)).astype(
                 np.float32)),
             "b.bf16": torch.from_numpy(rng.normal(size=(7,)).astype(
                 np.float32)).to(torch.bfloat16),
             "c.f16": torch.from_numpy(rng.normal(size=(2, 2, 3)).astype(
                 np.float16)),
             "d.i64": torch.arange(6).reshape(2, 3)}
    path = str(tmp_path / "mixed.safetensors")
    weights.save_safetensors(path, mixed)
    lib = load_file(path)
    ours = weights.load_safetensors(path)
    assert list(lib) == list(mixed) == list(ours)
    for k, v in mixed.items():
        assert lib[k].dtype == v.dtype and torch.equal(lib[k], v), k
        assert torch.equal(ours[k], v), k
    with pytest.raises(ValueError, match="b.bf16"):
        twt._save(str(tmp_path / "x.npz"), mixed)
