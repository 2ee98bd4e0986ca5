"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA card and skips without one. This file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Tolerances: bf16 outputs of magnitude < 4, where kernel and plain
version round at other places (P to bf16 in the CLIP kernel, int8
dequantized to bf16 in the plain decode) -- a few bf16 ulps. The W4A8
kernels quantize the activations exactly as their plain versions do and
form exact int32 partials, so only the f32 summation order differs:
max |err| / max |ref| <= 1e-4 in f32; with bf16 out, against the plain
f32 result rounded to bf16, one bf16 ulp: <= 2^-7 of max |ref|.
"""

import pytest
import torch

from video_llava_tpu_torch.ops import attention, cuda_lib, pooling, quant4

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


def _int4_weight(g, d, f, group_size):
    w = torch.randn(d, f, generator=g, device=g.device) * d ** -0.5
    return quant4.quantize_tensor_int4(w, group_size)


def _assert_rel(got, want, tol=1e-4):
    torch.cuda.synchronize()
    rel = ((got.float() - want.float()).abs().max()
           / want.float().abs().max()).item()
    assert rel <= tol, rel


@pytest.mark.parametrize("nb,d,f,group_size", [
    (1, 4096, 12288, 128), (1, 11008, 4096, 128), (4, 4096, 4096, 128),
    (3, 768, 256, 128), (8, 512, 384, 32), (2, 1024, 640, None),
    (5, 256, 128, None),
])
def test_w4a8_matvec_kernel_matches_plain(dev, nb, d, f, group_size):
    g = torch.Generator(device=dev).manual_seed(4)
    packed, scales = _int4_weight(g, d, f, group_size)
    x = torch.randn(nb, d, generator=g, device=dev).to(torch.bfloat16)
    before = cuda_lib.LAUNCHES["w4a8_matvec"]
    got = quant4.w4a8_matvec(x, packed, scales)
    assert cuda_lib.LAUNCHES["w4a8_matvec"] == before + 1
    want = quant4.int4_matmul_w4a8_xla(x, packed, scales)
    _assert_rel(got, want)
    # bf16 out: one rounding of the same f32 result, at most a bf16 ulp
    got = quant4.w4a8_matvec(x, packed, scales, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    _assert_rel(got, want.to(torch.bfloat16), 2 ** -7)


@pytest.mark.parametrize("nb,d,f,group_size", [
    (768, 4096, 22016, 128), (768, 11008, 4096, 128), (1100, 4096, 4096, 128),
    (9, 512, 256, 32), (70, 768, 144, 128), (33, 1024, 256, None),
])
def test_w4a8_block_kernel_matches_plain(dev, nb, d, f, group_size):
    g = torch.Generator(device=dev).manual_seed(5)
    packed, scales = _int4_weight(g, d, f, group_size)
    x = torch.randn(nb, d, generator=g, device=dev).to(torch.bfloat16)
    before = cuda_lib.LAUNCHES["w4a8_block"]
    got = quant4.w4a8_block(x, packed, scales)
    assert cuda_lib.LAUNCHES["w4a8_block"] == before + 1
    want = quant4.int4_matmul_w4a8_block_xla(x, packed, scales)
    _assert_rel(got, want)
    got = quant4.w4a8_block(x, packed, scales, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    _assert_rel(got, want.to(torch.bfloat16), 2 ** -7)


def test_int4_dispatch_on_the_card(dev):
    """Up to 8 rows the matvec, more rows the block kernel, a stacked
    layer a view of the (L, Dh, F) weight."""
    g = torch.Generator(device=dev).manual_seed(6)
    packed, scales = _int4_weight(g, 512, 256, 128)
    stacked_p = torch.stack([packed, packed.flip(0)])
    stacked_s = torch.stack([scales, scales.flip(0)])
    for rows, name in ((8, "w4a8_matvec"), (9, "w4a8_block")):
        x = torch.randn(rows, 512, generator=g,
                        device=dev).to(torch.bfloat16)
        before = cuda_lib.LAUNCHES[name]
        got = quant4.int4_matmul_stacked(x, stacked_p, stacked_s, 1)
        assert cuda_lib.LAUNCHES[name] == before + 1
        plain = (quant4.int4_matmul_w4a8_xla if rows <= 8
                 else quant4.int4_matmul_w4a8_block_xla)
        _assert_rel(got, plain(x, stacked_p[1], stacked_s[1]))


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
    packed, scales = _int4_weight(g, 512, 256, 128)
    xb = torch.randn(9, 512, device=dev).to(torch.bfloat16)
    with pytest.raises(ValueError):  # more rows than the matvec takes
        quant4.w4a8_matvec(xb, packed, scales)
    with pytest.raises(TypeError):  # scales must be bf16
        quant4.w4a8_block(xb, packed, scales.float())
    with pytest.raises(TypeError):  # the kernels read bf16 activations
        quant4.w4a8_block(xb.float(), packed, scales)
    with pytest.raises(TypeError):  # and write f32 or bf16
        quant4.w4a8_matvec(xb[:1], packed, scales, torch.float16)
