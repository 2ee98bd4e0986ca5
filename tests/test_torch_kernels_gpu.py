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
Deformable attention: f32 sums in another order, <= 1e-4 of max |ref|
in f32; in bf16 out, one bf16 rounding, <= 2^-7 of max |ref|. The W4A16
kernels form f32 group partials of exact products (integer nibbles times
bf16 activations) as their plain versions do: the same limits as W4A8.
Decode attention over a flat cache (kernels 9 and 11) as kernels 3 and
10: 2e-2 absolute and, row by row, 2^-6 of each row's max |ref|.
"""

import pytest
import torch

from video_llava_tpu_torch.ops import (
    attention,
    cuda_lib,
    deformable,
    pooling,
    quant4,
)

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
    (3, 2, 37, 8, 32, False), (3, 2, 37, 8, 32, True),
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
        before = cuda_lib.LAUNCHES["decode_attention_stacked"]
        got = attention.decode_attention_stacked(q, kc, vc, li, lens, ks, vs)
        assert cuda_lib.LAUNCHES["decode_attention_stacked"] == before + 1
        want = attention.decode_attention_stacked_plain(q, kc, vc, li, lens,
                                                        ks, vs)
        _assert_close(got, want, 2e-2)


@pytest.mark.parametrize("nb,bs,maxb,h,d,lens,int8", [
    (3, 16, 4, 4, 64, (1, 37, 64), False),
    (3, 16, 4, 4, 64, (1, 37, 64), True),
    (4, 64, 32, 32, 128, (1000, 2048, 63, 65), False),
    (4, 64, 32, 32, 128, (1, 64, 1000, 2048), True),
    (3, 16, 4, 8, 32, (1, 37, 64), False),
    (3, 16, 4, 8, 32, (1, 37, 64), True),
])
def test_paged_decode_kernel_matches_plain(dev, nb, bs, maxb, h, d, lens,
                                           int8):
    """Kernel 10 over a pool of 2 layers, rows' blocks drawn from a
    shuffled pool, the pad block 0 past each allocation."""
    g = torch.Generator(device=dev).manual_seed(7)
    pool = (2, 1 + sum(-(-n // bs) for n in lens), bs, h, d)
    q = _rand(g, nb, 1, h, d)
    if int8:
        kc, vc = (torch.randint(-127, 128, pool, generator=g, device=dev,
                                dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.rand(pool[:-1], generator=g, device=dev) / 127
                  for _ in range(2))
    else:
        kc, vc = (_rand(g, *pool) for _ in range(2))
        ks = vs = None
    perm = (torch.randperm(pool[1] - 1, generator=g, device=dev) + 1).tolist()
    table = torch.zeros((nb, maxb), dtype=torch.int32)
    for i, n in enumerate(lens):
        used = -(-n // bs)
        table[i, :used] = torch.tensor(perm[:used])
        perm = perm[used:]
    table = table.to(dev)
    cache_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    for li in range(2):
        before = cuda_lib.LAUNCHES["decode_attention_paged"]
        got = attention.decode_attention_paged(q, kc, vc, li, table,
                                               cache_len, ks, vs)
        assert cuda_lib.LAUNCHES["decode_attention_paged"] == before + 1
        want = attention.decode_attention_paged_plain(q, kc, vc, li, table,
                                                      cache_len, ks, vs)
        _assert_close(got, want, 2e-2)
        # row by row: a long row's outputs are small, so the absolute
        # limit alone would pass a wrong block there
        err = (got.float() - want.float()).abs().flatten(1).amax(1)
        rel = err / want.float().abs().flatten(1).amax(1)
        assert rel.max().item() <= 2 ** -6, rel.tolist()


def _flat_cache(g, dev, b, L, h_kv, d, int8):
    """A flat (b, L, h_kv, d) cache, bf16 or int8 with (b, L, h_kv, 1)
    scales."""
    if not int8:
        return _rand(g, b, L, h_kv, d), _rand(g, b, L, h_kv, d), None, None
    kc, vc = (torch.randint(-127, 128, (b, L, h_kv, d), generator=g,
                            device=dev, dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand((b, L, h_kv, 1), generator=g, device=dev) / 127
              for _ in range(2))
    return kc, vc, ks, vs


def _assert_rows(got, want, atol=2e-2, row_tol=2 ** -6):
    """Absolute, then row by row: max|err| / max|ref| of each (b, 1, h,
    d) output row."""
    _assert_close(got, want, atol)
    err = (got.float() - want.float()).abs().flatten(1).amax(1)
    rel = err / want.float().abs().flatten(1).amax(1)
    assert rel.max().item() <= row_tol, rel.tolist()


@pytest.mark.parametrize("b,L,h,d,int8", [
    (1, 832, 32, 128, False), (1, 832, 32, 128, True),
    (4, 2048, 32, 128, False), (2, 48, 4, 32, False), (2, 48, 4, 32, True),
    (3, 64, 4, 64, True),
])
def test_flat_mha_decode_kernel_matches_plain(dev, b, L, h, d, int8):
    """Kernel 9 (decode_attention_mxu): kernel 3's body at NL = 1. Only
    the plain version rounds q * scale to bf16 (as the JAX kernel does)
    and the weights to bf16; the kernel scales its f32 scores and keeps
    the weights f32."""
    g = torch.Generator(device=dev).manual_seed(12)
    q = _rand(g, b, 1, h, d)
    kc, vc, ks, vs = _flat_cache(g, dev, b, L, h, d, int8)
    lens = torch.randint(1, L + 1, (b,), generator=g, device=dev,
                         dtype=torch.int32)
    lens[0] = L
    before = cuda_lib.LAUNCHES["decode_attention_mxu"]
    got = attention.decode_attention_mxu(q, kc, vc, lens, ks, vs)
    assert cuda_lib.LAUNCHES["decode_attention_mxu"] == before + 1
    _assert_rows(got, attention.decode_attention_mxu_plain(q, kc, vc, lens,
                                                           ks, vs))


@pytest.mark.parametrize("b,L,h,h_kv,d,int8", [
    (1, 833, 32, 8, 128, False), (1, 833, 32, 8, 128, True),
    (2, 700, 32, 4, 128, False), (2, 37, 8, 2, 32, False),
    (2, 37, 8, 2, 32, True), (3, 64, 12, 1, 64, True),
    (2, 50, 6, 6, 64, False), (1, 2048, 16, 2, 128, True),
    (1, 100, 6, 2, 64, False),
])
def test_gqa_decode_kernel_matches_plain(dev, b, L, h, h_kv, d, int8):
    """Kernel 11 (decode_attention_pallas): groups 4, 8, 1 and 12 (run as
    three blocks of 4 heads), any L, against the f32 plain version."""
    g = torch.Generator(device=dev).manual_seed(13)
    q = _rand(g, b, 1, h, d)
    kc, vc, ks, vs = _flat_cache(g, dev, b, L, h_kv, d, int8)
    lens = torch.randint(1, L + 1, (b,), generator=g, device=dev,
                         dtype=torch.int32)
    lens[-1] = L
    before = cuda_lib.LAUNCHES["decode_attention_pallas"]
    got = attention.decode_attention_pallas(q, kc, vc, lens, ks, vs)
    assert cuda_lib.LAUNCHES["decode_attention_pallas"] == before + 1
    _assert_rows(got, attention.decode_attention_pallas_plain(
        q, kc, vc, lens, ks, vs))


def test_gqa_decode_longest_cache(dev):
    """Kernel 11's length limit comes from its C entry: at 32 query heads
    over 4 (a block holds 8), d 128, the scores of 8 heads and the warps'
    partial outputs fill the 227 KB of shared memory at L = 6,239. That
    length launches and matches the plain version; one more raises before
    any launch."""
    g = torch.Generator(device=dev).manual_seed(15)
    q = _rand(g, 1, 1, 32, 128)
    kc, vc, _, _ = _flat_cache(g, dev, 1, 6240, 4, 128, False)
    lens = torch.tensor([6239], dtype=torch.int32, device=dev)
    k1, v1 = kc[:, :6239].contiguous(), vc[:, :6239].contiguous()
    got = attention.decode_attention_pallas(q, k1, v1, lens)
    _assert_rows(got, attention.decode_attention_pallas_plain(q, k1, v1,
                                                              lens))
    before = sum(cuda_lib.LAUNCHES.values())
    with pytest.raises(ValueError, match="shared memory"):
        attention.decode_attention_pallas(q, kc, vc, lens)
    assert sum(cuda_lib.LAUNCHES.values()) == before


def test_decode_fallthrough_on_the_card(dev):
    """The stacked and paged wrappers send the shapes kernels 3 and 10 do
    not take to the flat dispatch: a GQA cache to kernel 11, a paged pool
    of 24-position blocks or enable_paged_kernel(False) through the dense
    gather to kernel 9; under set_default_impl('xla') the stacked, paged
    and flat wrappers raise on CUDA tensors and launch nothing."""
    g = torch.Generator(device=dev).manual_seed(14)
    lens = torch.tensor([45, 17], dtype=torch.int32, device=dev)
    q8 = _rand(g, 2, 1, 8, 64)
    kv = _rand(g, 2, 2, 48, 2, 64)  # GQA: 2 kv heads for 8 query heads
    table = torch.tensor([[1, 3], [2, 0]], dtype=torch.int32, device=dev)
    pool_gqa = _rand(g, 2, 4, 24, 2, 64)
    pool_mha = _rand(g, 2, 4, 24, 8, 64)  # blocks of 24: not 16's
    pool16 = _rand(g, 2, 7, 16, 8, 64)
    table16 = torch.tensor([[1, 3, 5], [2, 4, 0]], dtype=torch.int32,
                           device=dev)
    cases = (
        ("decode_attention_pallas",
         lambda: attention.decode_attention_stacked(q8, kv, kv, 1, lens),
         lambda: attention.decode_attention_pallas_plain(q8, kv[1], kv[1],
                                                         lens)),
        ("decode_attention_pallas",
         lambda: attention.decode_attention_paged(q8, pool_gqa, pool_gqa, 1,
                                                  table, lens),
         lambda: attention.decode_attention_paged_plain(
             q8, pool_gqa, pool_gqa, 1, table, lens)),
        ("decode_attention_mxu",
         lambda: attention.decode_attention_paged(q8, pool_mha, pool_mha, 0,
                                                  table, lens),
         lambda: attention.decode_attention_paged_plain(
             q8, pool_mha, pool_mha, 0, table, lens)),
    )
    for name, run, plain in cases:
        before = dict(cuda_lib.LAUNCHES)
        got = run()
        assert cuda_lib.LAUNCHES[name] == before.get(name, 0) + 1, name
        assert sum(cuda_lib.LAUNCHES.values()) == sum(before.values()) + 1
        _assert_rows(got, plain())
    try:
        attention.enable_paged_kernel(False)
        before = cuda_lib.LAUNCHES["decode_attention_mxu"]
        got = attention.decode_attention_paged(q8, pool16, pool16, 1,
                                               table16, lens)
        assert cuda_lib.LAUNCHES["decode_attention_mxu"] == before + 1
        _assert_rows(got, attention.decode_attention_paged_plain(
            q8, pool16, pool16, 1, table16, lens))
        attention.enable_paged_kernel(True)
        attention.set_default_impl("xla")
        before = sum(cuda_lib.LAUNCHES.values())
        for run in (
                lambda: attention.decode_attention_stacked(q8, kv, kv, 1,
                                                           lens),
                lambda: attention.decode_attention_paged(
                    q8, pool16, pool16, 1, table16, lens),
                lambda: attention.decode_attention(q8, kv[1], kv[1], lens)):
            with pytest.raises(RuntimeError, match="xla"):
                run()
        assert sum(cuda_lib.LAUNCHES.values()) == before
    finally:
        attention.enable_paged_kernel(True)
        attention.set_default_impl("auto")


def test_f32_product_of_bf16_operands(dev):
    """ops/quant.dot_f32 (the bf16 lm_head's logits, the int8 head's
    product) on the card: bf16 operands, f32 out, against the f32
    product of the same values: only the summation order differs."""
    from video_llava_tpu_torch.ops.quant import dot_f32, quantized_matmul

    g = torch.Generator(device=dev).manual_seed(8)
    x = _rand(g, 3, 4096)
    w = _rand(g, 4096, 32006) * 4096 ** -0.5
    got = dot_f32(x, w)
    assert got.dtype == torch.float32 and got.shape == (3, 32006)
    _assert_rel(got, x.float() @ w.float(), 1e-5)
    q = torch.randint(-127, 128, (4096, 512), generator=g, device=dev,
                      dtype=torch.int8)
    s = torch.rand((1, 512), generator=g, device=dev) / 127
    got = quantized_matmul(x, q, s)
    assert got.dtype == torch.bfloat16
    _assert_rel(got, ((x.float() @ q.float()) * s).to(torch.bfloat16),
                2 ** -7)


def test_dot_f32_gradients_on_the_card(dev):
    """The gradient of ops/quant.dot_f32 on CUDA (``aten::mm.dtype`` has
    none of its own): the bf16 lm_head's, for x and for the weight, and
    the int8 quantized_matmul's, against the f32 products of the same
    values; only summation order and the one cast to bf16 differ, so
    one bf16 ulp (2^-7 of max |ref|)."""
    from video_llava_tpu_torch.ops.quant import dot_f32, quantized_matmul

    g = torch.Generator(device=dev).manual_seed(9)
    x = _rand(g, 2, 3, 4096).requires_grad_()
    w = (_rand(g, 4096, 32006) * 4096 ** -0.5).requires_grad_()
    gy = torch.randn(2, 3, 32006, generator=g, device=dev)
    dot_f32(x, w).backward(gy)
    assert x.grad.dtype == w.grad.dtype == torch.bfloat16
    gy2 = gy.reshape(6, -1)
    _assert_rel(x.grad, (gy2 @ w.detach().float().t()).reshape(x.shape),
                2 ** -7)
    _assert_rel(w.grad, x.detach().float().reshape(6, -1).t() @ gy2, 2 ** -7)
    x.grad = None
    q = torch.randint(-127, 128, (4096, 512), generator=g, device=dev,
                      dtype=torch.int8)
    s = torch.rand((1, 512), generator=g, device=dev) / 127
    gq = torch.randn(2, 3, 512, generator=g, device=dev).to(torch.bfloat16)
    quantized_matmul(x, q, s).backward(gq)
    want = ((gq.float() * s) @ q.float().t()).to(torch.bfloat16)
    _assert_rel(x.grad, want, 2 ** -7)


# b, sq, skv, h, h_kv, d, causal: the training layer's shape at a small
# batch, GQA, ragged right-aligned, non-causal, and every tile width
FLASH_SHAPES = [
    (1, 256, 256, 8, 8, 128, True), (2, 130, 130, 8, 2, 64, True),
    (1, 100, 137, 4, 4, 128, True), (2, 77, 50, 4, 2, 32, False),
    (1, 129, 129, 2, 1, 16, False), (1, 64, 96, 3, 3, 80, True),
    (1, 33, 33, 2, 2, 48, True), (1, 70, 70, 2, 2, 96, False),
    (1, 65, 65, 2, 2, 112, True),
]


def _flash_inputs(g, b, sq, skv, h, h_kv, d):
    return (_rand(g, b, sq, h, d), _rand(g, b, skv, h_kv, d),
            _rand(g, b, skv, h_kv, d), _rand(g, b, sq, h, d))


@pytest.mark.parametrize("b,sq,skv,h,h_kv,d,causal", FLASH_SHAPES)
def test_flash_kernels_match_plain(dev, b, sq, skv, h, h_kv, d, causal):
    """Kernels 7 and 8 against their plain versions on the same bf16
    inputs (the backward's out and lse are the kernel forward's). Forward:
    absolute 2e-2 (P rounded to bf16 for the second product) and, for
    every (row, head), max|err| <= 2^-6 of that row's max |ref|; lse to
    1e-3. dq, dk, dv: each within 2e-2 of its tensor's max |ref| (bf16
    P and dS in the products, sums in another order)."""
    gen = torch.Generator(device=dev).manual_seed(10)
    q, k, v, do = _flash_inputs(gen, b, sq, skv, h, h_kv, d)
    before = dict(cuda_lib.LAUNCHES)
    out, lse = attention.flash_forward(q, k, v, causal)
    want, want_lse = attention.flash_forward_plain(q, k, v, causal)
    _assert_close(out, want, 2e-2)
    _assert_close(lse, want_lse, 1e-3)
    err = (out.float() - want.float()).abs().amax(-1)
    assert (err / want.float().abs().amax(-1)).max().item() <= 2 ** -6
    got = attention.flash_backward(q, k, v, out, lse, do, causal)
    ref = attention.flash_backward_plain(q, k, v, out, lse, do, causal)
    for a, r in zip(got, ref):
        assert a.dtype == r.dtype == torch.bfloat16 and a.shape == r.shape
        _assert_rel(a, r, 2e-2)
    for name in ("flash_forward", "flash_backward_dq", "flash_backward_dkv"):
        assert cuda_lib.LAUNCHES[name] == before.get(name, 0) + 1, name


def test_flash_attention_autograd_on_the_card(dev):
    """multi_head_attention on CUDA tensors goes through the autograd
    function: kernel 7 forward, kernel 8 backward, gradients those of
    the plain backward (2e-2 of max |ref|)."""
    gen = torch.Generator(device=dev).manual_seed(11)
    q, k, v, do = _flash_inputs(gen, 2, 96, 96, 4, 2, 64)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = dict(cuda_lib.LAUNCHES)
    out = attention.multi_head_attention(*leaves, causal=True)
    out.backward(do)
    for name in ("flash_forward", "flash_backward_dq", "flash_backward_dkv"):
        assert cuda_lib.LAUNCHES[name] == before.get(name, 0) + 1, name
    o, lse = attention.flash_forward_plain(q, k, v, True)
    ref = attention.flash_backward_plain(q, k, v, out.detach(), lse, do,
                                         True)
    for leaf, r in zip(leaves, ref):
        _assert_rel(leaf.grad, r, 2e-2)
    _assert_close(out, o, 2e-2)


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


@pytest.mark.parametrize("d,f,group_size", [
    (4096, 12288, 128), (4096, 4096, 128), (4096, 22016, 128),
    (11008, 4096, 128), (768, 256, 128), (512, 384, 32), (1024, 640, None),
])
def test_w4a16_matvec_kernel_matches_plain(dev, d, f, group_size):
    g = torch.Generator(device=dev).manual_seed(15)
    packed, scales = _int4_weight(g, d, f, group_size)
    x = torch.randn(1, d, generator=g, device=dev).to(torch.bfloat16)
    before = cuda_lib.LAUNCHES["w4a16_matvec"]
    got = quant4.w4a16_matvec(x, packed, scales)
    assert cuda_lib.LAUNCHES["w4a16_matvec"] == before + 1
    want = quant4.int4_matmul_w4a16_matvec_plain(x, packed, scales)
    _assert_rel(got, want)
    got = quant4.w4a16_matvec(x, packed, scales, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    _assert_rel(got, want.to(torch.bfloat16), 2 ** -7)


@pytest.mark.parametrize("nb,d,f,group_size", [
    (768, 4096, 22016, 128), (2, 4096, 4096, 128), (36, 11008, 4096, 128),
    (9, 512, 256, 32), (70, 768, 144, 128), (33, 1024, 256, None),
])
def test_w4a16_block_kernel_matches_plain(dev, nb, d, f, group_size):
    g = torch.Generator(device=dev).manual_seed(16)
    packed, scales = _int4_weight(g, d, f, group_size)
    x = torch.randn(nb, d, generator=g, device=dev).to(torch.bfloat16)
    before = cuda_lib.LAUNCHES["w4a16_block"]
    got = quant4.w4a16_block(x, packed, scales)
    assert cuda_lib.LAUNCHES["w4a16_block"] == before + 1
    want = quant4.int4_matmul_w4a16_block_plain(x, packed, scales)
    _assert_rel(got, want)
    got = quant4.w4a16_block(x, packed, scales, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    _assert_rel(got, want.to(torch.bfloat16), 2 ** -7)


def test_int4_dispatch_on_the_card(dev, monkeypatch):
    """Under the default switches up to 8 rows the W4A8 matvec, more rows
    the W4A8 block kernel; with A8_DECODE off one row the W4A16 matvec and
    2-8 rows the W4A16 block matmul; with A8_BLOCK off more rows the W4A16
    block matmul. A stacked layer is a view of the (L, Dh, F) weight."""
    g = torch.Generator(device=dev).manual_seed(6)
    packed, scales = _int4_weight(g, 512, 256, 128)
    stacked_p = torch.stack([packed, packed.flip(0)])
    stacked_s = torch.stack([scales, scales.flip(0)])
    plains = {"w4a8_matvec": quant4.int4_matmul_w4a8_xla,
              "w4a8_block": quant4.int4_matmul_w4a8_block_xla,
              "w4a16_matvec": quant4.int4_matmul_w4a16_matvec_plain,
              "w4a16_block": quant4.int4_matmul_w4a16_block_plain}
    for a8, a8_block, rows, name in (
            (True, True, 8, "w4a8_matvec"), (True, True, 9, "w4a8_block"),
            (False, True, 1, "w4a16_matvec"), (False, True, 4, "w4a16_block"),
            (False, True, 9, "w4a8_block"), (True, False, 9, "w4a16_block"),
            (True, False, 1, "w4a8_matvec"), (False, False, 1,
                                              "w4a16_matvec")):
        monkeypatch.setattr(quant4, "A8_DECODE", a8)
        monkeypatch.setattr(quant4, "A8_BLOCK", a8_block)
        x = torch.randn(rows, 512, generator=g,
                        device=dev).to(torch.bfloat16)
        before = cuda_lib.LAUNCHES[name]
        got = quant4.int4_matmul_stacked(x, stacked_p, stacked_s, 1)
        assert cuda_lib.LAUNCHES[name] == before + 1, (a8, a8_block, rows)
        _assert_rel(got, plains[name](x, stacked_p[1], stacked_s[1]))


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    g = torch.Generator(device=dev).manual_seed(3)
    q = _rand(g, 1, 1, 8, 72)
    kv = _rand(g, 2, 1, 16, 4, 72)  # head dim 72: no decode kernel takes it
    lens = torch.tensor([5], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        attention.decode_attention_stacked(q, kv, kv, 0, lens)
    table = torch.zeros((1, 2), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):  # paged: through the same flat kernels
        attention.decode_attention_paged(q, kv, kv, 0, table, lens)
    with pytest.raises(ValueError):  # 8 query heads over 3 kv heads
        kv3 = _rand(g, 1, 16, 3, 64)
        attention.decode_attention_pallas(q[..., :64].contiguous(), kv3, kv3,
                                          lens)
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
    qf = _rand(g, 1, 8, 4, 64)
    with pytest.raises(TypeError):  # the flash kernels read bf16
        attention.flash_forward(qf.float(), qf.float(), qf.float())
    with pytest.raises(ValueError):  # causal needs sq <= skv
        attention.flash_forward(qf, qf[:, :4], qf[:, :4], causal=True)
    with pytest.raises(ValueError):  # 4 query heads over 3 kv heads
        kv3 = qf[:, :, :3].contiguous()
        attention.flash_forward(qf, kv3, kv3)
    q72 = _rand(g, 1, 8, 2, 72)
    with pytest.raises(ValueError):  # d % 8 == 0 dispatches, 72 raises
        attention.multi_head_attention(q72, q72, q72, causal=True)


@pytest.mark.parametrize("shapes,q,b,nh,hd,p,dtype", [
    (((100, 100), (50, 50), (25, 25), (13, 13)), 900, 2, 8, 32, 4,
     torch.float32),
    (((12, 12), (6, 6), (3, 3)), 189, 1, 4, 64, 4, torch.bfloat16),
    (((10, 14), (5, 7)), 33, 3, 2, 128, 3, torch.float32),
    (((9, 9), (4, 4), (2, 2), (1, 1), (1, 1)), 17, 1, 8, 96, 6,
     torch.bfloat16),
    (((16, 16), (8, 8), (4, 4)), 336, 2, 4, 8, 4, torch.float32),
    (((7, 5), (3, 2)), 41, 2, 3, 40, 4, torch.bfloat16),
])
def test_deformable_kernel_matches_plain(dev, shapes, q, b, nh, hd, p,
                                         dtype):
    g = torch.Generator(device=dev).manual_seed(0)
    sum_hw = sum(h * w for h, w in shapes)
    value = _rand(g, b, sum_hw, nh, hd, dtype=dtype)
    locs = torch.rand((b, q, nh, len(shapes), p, 2), generator=g,
                      device=dev) * 1.4 - 0.2
    locs[0, 1, 0, 0, 0, 0] = float("nan")
    locs[0, 2, 0, 0, 0, 1] = float("inf")
    weights = torch.rand((b, q, nh, len(shapes), p), generator=g,
                         device=dev)
    before = cuda_lib.LAUNCHES["multi_scale_deformable_attention"]
    got = deformable.multi_scale_deformable_attention(value, shapes, locs,
                                                      weights)
    assert cuda_lib.LAUNCHES["multi_scale_deformable_attention"] == before + 1
    want = deformable.msda_plain(value, shapes, locs, weights)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == dtype
    rel = ((got.float() - want.float()).abs().max()
           / want.float().abs().max()).item()
    assert rel <= (1e-4 if dtype == torch.float32 else 2 ** -7), rel
    deformable.set_tile2d(True)
    try:
        again = deformable.multi_scale_deformable_attention(value, shapes,
                                                            locs, weights)
    finally:
        deformable.set_tile2d(False)
    assert torch.equal(again, got)
    with pytest.raises(ValueError):  # more samples than a warp's lanes
        deformable.multi_scale_deformable_attention(
            value, shapes, torch.cat([locs] * 9, dim=4),
            torch.cat([weights] * 9, dim=4))
