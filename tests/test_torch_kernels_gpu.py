"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA card and skips without one. This file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Tolerances: bf16 outputs of magnitude < 4, where kernel and plain
version round at other places (P to bf16 in the CLIP kernel, int8
dequantized to bf16 in the plain decode) -- a few bf16 ulps.
"""

import pytest
import torch

from video_llava_tpu_torch.ops import attention, cuda_lib, pooling

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def _rand(g, *shape, dtype=torch.bfloat16):
    return torch.randn(*shape, generator=g, device=g.device).to(dtype)


def _assert_close(got, want, atol):
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= atol, err


@pytest.mark.parametrize("b,h,s,kv_len,d", [
    (2, 4, 32, 23, 64), (3, 2, 100, 100, 128), (1, 2, 640, 577, 64),
    (2, 3, 48, 17, 16),
])
def test_flash_bhsd_kernel_matches_plain(dev, b, h, s, kv_len, d):
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (_rand(g, b, h, s, d) for _ in range(3))
    before = cuda_lib.LAUNCHES["flash_attention_bhsd"]
    got = attention.flash_attention_bhsd(q, k, v, kv_len=kv_len)
    assert cuda_lib.LAUNCHES["flash_attention_bhsd"] == before + 1
    want = attention.flash_attention_bhsd_plain(q, k, v, kv_len=kv_len)
    _assert_close(got, want, 2e-2)


@pytest.mark.parametrize("t,s,c,n,out_dtype", [
    (100, 256, 1024, 100, torch.bfloat16), (12, 256, 1024, 12,
                                            torch.bfloat16),
    (7, 50, 100, 5, torch.float32), (3, 17, 64, 9, torch.float32),
])
def test_pool_kernel_matches_plain(dev, t, s, c, n, out_dtype):
    g = torch.Generator(device=dev).manual_seed(1)
    x = _rand(g, t, s, c)
    got = pooling.spatio_temporal_pool_fused(x, n, out_dtype=out_dtype)
    want = pooling.spatio_temporal_pool(x, n, out_dtype=out_dtype)
    assert got.dtype == out_dtype and got.shape == want.shape
    _assert_close(got, want, 1e-2 if out_dtype == torch.bfloat16 else 1e-5)


@pytest.mark.parametrize("nl,b,L,h,d,int8", [
    (3, 2, 37, 4, 64, False), (3, 2, 37, 4, 64, True),
    (2, 1, 833, 32, 128, False), (2, 1, 833, 32, 128, True),
])
def test_decode_kernel_matches_plain(dev, nl, b, L, h, d, int8):
    g = torch.Generator(device=dev).manual_seed(2)
    q = _rand(g, b, 1, h, d)
    lens = torch.randint(1, L + 1, (b,), generator=g, device=dev,
                         dtype=torch.int32)
    if int8:
        kc, vc = (torch.randint(-127, 128, (nl, b, L, h, d), generator=g,
                                device=dev, dtype=torch.int8)
                  for _ in range(2))
        ks, vs = (torch.rand((nl, b, L, h), generator=g, device=dev) / 127
                  for _ in range(2))
    else:
        kc, vc = (_rand(g, nl, b, L, h, d) for _ in range(2))
        ks = vs = None
    for li in range(nl):
        got = attention.decode_attention_stacked(q, kc, vc, li, lens, ks, vs)
        want = attention.decode_attention_stacked_plain(q, kc, vc, li, lens,
                                                        ks, vs)
        _assert_close(got, want, 2e-2)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    g = torch.Generator(device=dev).manual_seed(3)
    q = _rand(g, 1, 1, 8, 64)
    kv = _rand(g, 2, 1, 16, 4, 64)  # GQA: 4 kv heads for 8 query heads
    lens = torch.tensor([5], dtype=torch.int32, device=dev)
    with pytest.raises(NotImplementedError):
        attention.decode_attention_stacked(q, kv, kv, 0, lens)
    x = _rand(g, 1, 2, 32, 64)
    with pytest.raises(TypeError):
        attention.flash_attention_bhsd(x.float(), x.float(), x.float())
    with pytest.raises(ValueError):
        attention.flash_attention_bhsd(x, x, x.transpose(2, 3))
    with pytest.raises(TypeError):  # the pool kernel reads bf16 only
        pooling.spatio_temporal_pool_fused(x[0].float())
