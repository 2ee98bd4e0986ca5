"""The port's checkpoint file readers (engine/weights.py), which use no
safetensors package: load_safetensors against safetensors.torch for F32,
F16 and BF16 (bit for bit, in the file's dtype; safetensors.numpy cannot
read BF16) and against the JAX package's loader for F32 and F16; sharded
and single-file directories in both formats, one shard at a time; and a
.pth with the research repos' {'model': sd} nesting."""

import os

import numpy as np
import torch
from safetensors.torch import load_file, save_file

from torch_ckpt_pair import write_shards
from video_llava_tpu.engine import weights as jax_weights
from video_llava_tpu_torch.engine import weights


def _equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.view(-1).view(torch.uint8) if a.numel() else a,
                            b.view(-1).view(torch.uint8) if b.numel() else b))


def test_reader_matches_safetensors_and_jax(tmp_path):
    g = torch.Generator().manual_seed(0)
    sd = {"a.weight": torch.randn(7, 5, generator=g),
          "b.bias": torch.randn(3, generator=g).half(),
          "c.kernel": torch.randn(4, 6, 2, generator=g).bfloat16(),
          "d.scalar": torch.tensor(1.5),
          "e.ids": torch.arange(10, dtype=torch.int64).reshape(2, 5),
          "f.empty": torch.zeros(0, 4)}
    path = str(tmp_path / "x.safetensors")
    save_file(sd, path, metadata={"format": "pt"})
    got, want = weights.load_safetensors(path), load_file(path)
    assert set(got) == set(want) == set(sd)
    for k in sd:
        assert _equal(got[k], want[k]) and _equal(got[k], sd[k]), k
    # the JAX package's loader (safetensors.numpy) for what it can read
    plain = {k: v for k, v in sd.items() if v.dtype != torch.bfloat16}
    save_file(plain, str(tmp_path / "y.safetensors"))
    jax_sd = jax_weights.load_safetensors(str(tmp_path / "y.safetensors"))
    port_sd = weights.load_safetensors(str(tmp_path / "y.safetensors"))
    for k, v in jax_sd.items():
        np.testing.assert_array_equal(port_sd[k].numpy(), v, err_msg=k)
        assert port_sd[k].numpy().dtype == v.dtype, k

    # directories: sharded and single, safetensors and .bin; the shards
    # come one at a time and together hold the state dict
    big = {f"layers.{i}.w": torch.randn(8, 4, generator=g).bfloat16()
           for i in range(5)}
    for fmt in ("safetensors", "bin"):
        for shards in (1, 3):
            d = str(tmp_path / f"{fmt}{shards}")
            write_shards(d, big, fmt, shards)
            files = weights.checkpoint_files(d)
            assert len(files) == shards
            parts = list(weights.checkpoint_shards(d))
            assert len(parts) == shards
            assert sum(len(p) for p in parts) == len(big)
            whole = weights.load_checkpoint_dir(d)
            assert set(whole) == set(big)
            for k in big:
                assert _equal(whole[k], big[k]), (fmt, shards, k)
            if fmt == "bin":  # the JAX loader reads .bin (as f32)
                jax_whole = jax_weights.load_checkpoint_dir(d)
                for k in big:
                    np.testing.assert_array_equal(
                        whole[k].float().numpy(), jax_whole[k])
    try:
        weights.checkpoint_files(str(tmp_path))
        raise AssertionError("an empty directory must raise")
    except FileNotFoundError:
        pass

    # a research-repo .pth: {'model': sd} nesting and non-tensor entries
    pth = str(tmp_path / "head.pth")
    torch.save({"model": {**plain, "note": 3}, "epoch": 7}, pth)
    got = weights.load_torch_checkpoint_file(pth)
    want = jax_weights.load_torch_checkpoint_file(pth)
    assert set(got) == set(want) == set(plain)
    for k in plain:
        assert _equal(got[k], plain[k]), k
    torch.save({"state_dict": plain}, pth)
    assert set(weights.load_torch_checkpoint_file(pth)) == set(plain)
    assert os.path.exists(pth)
