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
Kernel 7's f32 body: f32 on both sides, sums in another order, outputs
of magnitude < 4 and lse: 2e-5 absolute; kernel 8's f32 body: 1e-5 of
each gradient's max |ref|.
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
    (2, 3, 48, 17, 16), (2, 16, 272, 257, 64), (1, 16, 272, 65, 64),
    (1, 2, 272, 1, 64), (1, 4, 640, 577, 64), (1, 65537, 16, 16, 64),
    (1, 65537, 16, 9, 16), (1, 2, 512, 500, 128), (100, 8, 272, 257, 64),
])
def test_flash_bhsd_kernel_matches_plain(dev, b, h, s, kv_len, d):
    """Kernel 1: the Hopper body at d 64 and 128 (CLIP's 224 px tiling,
    its 336 px one, 500 keys at d 128, one valid key, more than 65,535
    heads, a tensor-parallel rank's 8 of CLIP-L's 16 heads over 100
    frames), the WMMA body at d 16. The pad rows of k and v are large, so a
    leaked pad key shows."""
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (_rand(g, b, h, s, d) for _ in range(3))
    k[:, :, kv_len:], v[:, :, kv_len:] = 30.0, 100.0
    before = cuda_lib.LAUNCHES["flash_attention_bhsd"]
    got = attention.flash_attention_bhsd(q, k, v, kv_len=kv_len)
    assert cuda_lib.LAUNCHES["flash_attention_bhsd"] == before + 1
    want = attention.flash_attention_bhsd_plain(q, k, v, kv_len=kv_len)
    _assert_close(got, want, 2e-2)


@pytest.mark.parametrize("b,h,s,kv_len,d", [
    (32, 12, 64, 50, 64), (2, 4, 32, 23, 64), (3, 2, 100, 100, 128),
    (2, 3, 48, 17, 16), (2, 16, 272, 257, 64), (1, 2, 272, 1, 64),
    (1, 65537, 16, 9, 16),
])
def test_flash_bhsd_f32_kernel_matches_plain(dev, b, h, s, kv_len, d):
    """Kernel 1's f32 body (the ViT-B/32 crop filter's (32, 12, 64, 64)
    at 50 keys, CLIP-L's tiling, one valid key, d 16 and 128, more than
    65,535 heads): 3xTF32 against the plain f32 version within 2e-5, the
    pad rows of k and v large."""
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(b, h, s, d, generator=g, device=dev)
               for _ in range(3))
    k[:, :, kv_len:], v[:, :, kv_len:] = 30.0, 100.0
    before = cuda_lib.LAUNCHES["flash_attention_bhsd_f32"]
    got = attention.flash_attention_bhsd(q, k, v, kv_len=kv_len)
    assert cuda_lib.LAUNCHES["flash_attention_bhsd_f32"] == before + 1
    assert got.dtype == torch.float32
    want = attention.flash_attention_bhsd_plain(q, k, v, kv_len=kv_len)
    _assert_close(got, want, 2e-5)


@pytest.mark.parametrize("t,s,c,n,out_dtype", [
    (100, 256, 1024, 100, torch.bfloat16), (12, 256, 1024, 12,
                                            torch.bfloat16),
    (7, 50, 100, 5, torch.float32), (3, 17, 64, 9, torch.float32),
    (1, 256, 1024, 1, torch.bfloat16), (12, 256, 1024, 0, torch.bfloat16),
    (12, 256, 1024, 9, torch.bfloat16), (12, 256, 1024, 9, torch.float32),
    (20, 33, 1000, 17, torch.float32), (5, 70, 36, 2, torch.bfloat16),
    (40, 577, 1024, 40, torch.bfloat16),
])
def test_pool_kernel_matches_plain(dev, t, s, c, n, out_dtype):
    """Kernel 2 at the chat's 100 and 12 frames, one frame, no valid
    frame, 9 of 12, n past t, and s and c that do not divide the block's
    32 patches x 64 channels (c % 8 != 0 takes the scalar loads)."""
    g = torch.Generator(device=dev).manual_seed(1)
    x = _rand(g, t, s, c)
    got = pooling.spatio_temporal_pool_fused(x, n, out_dtype=out_dtype)
    want = pooling.spatio_temporal_pool(x, n, out_dtype=out_dtype)
    assert got.dtype == out_dtype and got.shape == want.shape
    _assert_close(got, want, 1e-2 if out_dtype == torch.bfloat16 else 1e-5)


@pytest.mark.parametrize("b,t,s,c,counts,out_dtype", [
    (8, 100, 256, 1024, (100, 100, 73, 100, 12, 100, 100, 1),
     torch.bfloat16),
    (3, 8, 256, 1024, (8, 5, 1), torch.float32),
    (4, 12, 33, 100, (0, 12, 13, 7), torch.float32),
])
def test_batched_pool_kernel_matches_plain(dev, b, t, s, c, counts,
                                           out_dtype):
    """Kernel 2 over a batch of videos in one launch, a valid count a
    video read from a device tensor (mixed counts, one of none and one
    past t): against the batched plain version at the limits of
    test_pool_kernel_matches_plain, and bit for bit against one launch a
    video."""
    g = torch.Generator(device=dev).manual_seed(5)
    x = _rand(g, b, t, s, c)
    n = torch.tensor(counts, dtype=torch.int32, device=dev)
    before = cuda_lib.LAUNCHES["spatio_temporal_pool"]
    got = pooling.spatio_temporal_pool_fused(x, n, out_dtype=out_dtype)
    assert cuda_lib.LAUNCHES["spatio_temporal_pool"] == before + 1
    want = pooling.spatio_temporal_pool(x, n, out_dtype=out_dtype)
    assert got.dtype == out_dtype and got.shape == want.shape == (
        b, 100 + s, c)
    _assert_close(got, want, 1e-2 if out_dtype == torch.bfloat16 else 1e-5)
    for i, ni in enumerate(counts):
        one = pooling.spatio_temporal_pool_fused(x[i], ni,
                                                 out_dtype=out_dtype)
        assert torch.equal(got[i], one), i


@pytest.mark.parametrize("t,s,c,n,denom", [
    (50, 256, 1024, 50, 100), (50, 256, 1024, 23, 73),
    (50, 256, 1024, 0, 30), (7, 50, 100, 5, 9), (3, 17, 64, 9, 2),
])
def test_pool_kernel_with_a_divisor_matches_plain(dev, t, s, c, n, denom):
    """Kernel 2 with the spatial sums divided by another count than the
    valid frames' (one 'data' shard of the frame-sharded pooling: 50 of
    100 frames, all valid, 23 of 73 valid, none of 30 valid; then odd
    shapes), f32 out as the sharded form takes it, against
    pooling.pool_shard_plain within 1e-5; and the same kernel without a
    divisor is bit for bit the divisor equal to the count."""
    g = torch.Generator(device=dev).manual_seed(6)
    x = _rand(g, t, s, c)
    got = pooling.spatio_temporal_pool_fused(x, n, t, torch.float32,
                                             n_denom=denom)
    want = pooling.pool_shard_plain(x, n, denom, t, torch.float32)
    assert got.shape == want.shape == (t + s, c)
    _assert_close(got, want, 1e-5)
    if n == 0:
        assert not got.any()
    same = pooling.spatio_temporal_pool_fused(x, n, t, torch.float32,
                                              n_denom=n)
    assert torch.equal(same, pooling.spatio_temporal_pool_fused(
        x, n, t, torch.float32))


def test_pool_kernel_is_deterministic(dev):
    """Kernel 2's sums run in a fixed order (the temporal partials added
    in run order): the same bits on every launch."""
    g = torch.Generator(device=dev).manual_seed(4)
    x = _rand(g, 100, 256, 1024)
    first = pooling.spatio_temporal_pool_fused(x, 100)
    for _ in range(3):
        assert torch.equal(pooling.spatio_temporal_pool_fused(x, 100), first)


@pytest.mark.parametrize("nl,b,L,h,d,int8", [
    (3, 2, 37, 4, 64, False), (3, 2, 37, 4, 64, True),
    (2, 1, 833, 32, 128, False), (2, 1, 833, 32, 128, True),
    (3, 2, 37, 8, 32, False), (3, 2, 37, 8, 32, True),
    # a tensor-parallel rank's 16 of Vicuna-7B's 32 heads
    (2, 1, 833, 16, 128, False), (2, 1, 833, 16, 128, True),
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


def _paged_pool(g, dev, lens, bs, maxb, h, d, int8, nl=2):
    """A pool of nl layers holding `lens` rows, each row's blocks drawn
    from a shuffled pool, the pad block 0 past its allocation -> (k, v,
    k_scale, v_scale, table)."""
    pool = (nl, 1 + sum(-(-n // bs) for n in lens), bs, h, d)
    if int8:
        kc, vc = (torch.randint(-127, 128, pool, generator=g, device=dev,
                                dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.rand(pool[:-1], generator=g, device=dev) / 127
                  for _ in range(2))
    else:
        kc, vc = (_rand(g, *pool) for _ in range(2))
        ks = vs = None
    perm = (torch.randperm(pool[1] - 1, generator=g, device=dev) + 1).tolist()
    table = torch.zeros((len(lens), maxb), dtype=torch.int32)
    for i, n in enumerate(lens):
        used = -(-n // bs)
        table[i, :used] = torch.tensor(perm[:used], dtype=torch.int32)
        perm = perm[used:]
    return kc, vc, ks, vs, table.to(dev)


@pytest.mark.parametrize("int8", [False, True])
def test_paged_decode_rows_at_chunk_edges(dev, int8):
    """Kernel 10 with row lengths at the plan's chunk edges (one short of
    a chunk, a chunk, one past it, two chunks), a full table and an empty
    row, which writes 0 (the plain version, the JAX package's XLA path,
    averages every value there; a decode row is never empty). Twice: the
    partials merge in split order, so the result is the same bits."""
    g = torch.Generator(device=dev).manual_seed(17)
    bs, maxb, h, d = 64, 32, 32, 128
    chunk, splits = attention.paged_split_plan(
        maxb, bs, 6, h, attention._sm_count(dev.index))
    assert splits > 2
    lens = [chunk - 1, chunk, chunk + 1, 2 * chunk, maxb * bs, 0]
    kc, vc, ks, vs, table = _paged_pool(g, dev, lens, bs, maxb, h, d, int8)
    q = _rand(g, len(lens), 1, h, d)
    cache_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    args = (q, kc, vc, 1, table, cache_len, ks, vs)
    before = cuda_lib.LAUNCHES["decode_attention_paged"]
    got = attention.decode_attention_paged(*args)
    assert cuda_lib.LAUNCHES["decode_attention_paged"] == before + 1
    again = attention.decode_attention_paged(*args)
    want = attention.decode_attention_paged_plain(*args)
    _assert_rows(got[:-1], want[:-1])
    assert not got[-1].any()
    assert torch.equal(got, again)


@pytest.mark.parametrize("int8", [False, True])
def test_decode_kernels_at_65536_positions(dev, int8):
    """Kernels 3, 9 and 10 at 65,536 positions, past the shared memory
    of the per-(head, row) body they once had (about 57,000 scores at d
    64), where that body could not go: all three are split bodies at one
    head a block for every length, each launch counted under its own
    kernel's name."""
    g = torch.Generator(device=dev).manual_seed(18)
    L, h, d = 65536, 4, 64
    lens = torch.tensor([L, 40000], dtype=torch.int32, device=dev)
    q = _rand(g, 2, 1, h, d)
    kc, vc, ks, vs = _flat_cache(g, dev, 2, L, h, d, int8)
    stacked = lambda a: None if a is None else a[None, ..., 0]  # noqa
    for name, run, plain in (
            ("decode_attention_stacked",
             lambda: attention.decode_attention_stacked(
                 q, kc[None], vc[None], 0, lens, stacked(ks), stacked(vs)),
             lambda: attention.decode_attention_stacked_plain(
                 q, kc[None], vc[None], 0, lens, stacked(ks), stacked(vs))),
            ("decode_attention_mxu",
             lambda: attention.decode_attention_mxu(q, kc, vc, lens, ks, vs),
             lambda: attention.decode_attention_mxu_plain(q, kc, vc, lens,
                                                          ks, vs))):
        before = dict(cuda_lib.LAUNCHES)
        got = run()
        assert cuda_lib.LAUNCHES[name] == before.get(name, 0) + 1, name
        assert sum(cuda_lib.LAUNCHES.values()) == sum(before.values()) + 1
        _assert_rows(got, plain())
    del kc, vc, ks, vs
    pk, pv, pks, pvs, table = _paged_pool(g, dev, lens.tolist(), 64, 1024,
                                          h, d, int8, nl=1)
    args = (q, pk, pv, 0, table, lens, pks, pvs)
    before = cuda_lib.LAUNCHES["decode_attention_paged"]
    got = attention.decode_attention_paged(*args)
    assert cuda_lib.LAUNCHES["decode_attention_paged"] == before + 1
    _assert_rows(got, attention.decode_attention_paged_plain(*args))


@pytest.mark.parametrize("int8", [False, True])
def test_mha_decode_merge_is_deterministic(dev, int8):
    """Kernels 3 and 9 merge each (row, head)'s chunks in the last block
    to arrive, in split order whatever the order of arrival: three calls
    give the same bits, at the chat cache (13 chunks on an H100) and the
    serving rows."""
    g = torch.Generator(device=dev).manual_seed(19)
    for b, L, lens in ((1, 832, [734]), (4, 2048, [1000, 2048, 63, 64])):
        q = _rand(g, b, 1, 32, 128)
        kc, vc, ks, vs = _flat_cache(g, dev, b, L, 32, 128, int8)
        cache_len = torch.tensor(lens, dtype=torch.int32, device=dev)
        _, splits = attention.mha_split_plan(L, b, 32,
                                             attention._sm_count(dev.index))
        assert splits > 1
        runs = [attention.decode_attention_mxu(q, kc, vc, cache_len, ks, vs)
                for _ in range(3)]
        _assert_rows(runs[0], attention.decode_attention_mxu_plain(
            q, kc, vc, cache_len, ks, vs))
        assert all(torch.equal(r, runs[0]) for r in runs[1:])


def test_mha_decode_counters_are_reset(dev):
    """The last block of a (row, head) sets its arrival counter back to
    0, so calls in a row at three different split counts (and one at a
    single split, which uses no counter) each match the plain version,
    twice over."""
    g = torch.Generator(device=dev).manual_seed(20)
    sms = attention._sm_count(dev.index)
    cases = []
    for b, L, h in ((1, 832, 32), (4, 2048, 32), (2, 64, 4), (8, 16, 32)):
        q = _rand(g, b, 1, h, 128)
        kc, vc, _, _ = _flat_cache(g, dev, b, L, h, 128, False)
        lens = torch.randint(1, L + 1, (b,), generator=g, device=dev,
                             dtype=torch.int32)
        cases.append((q, kc, vc, lens))
    splits = [attention.mha_split_plan(c[1].shape[1], c[0].shape[0],
                                       c[0].shape[2], sms)[1] for c in cases]
    assert len(set(splits[:3])) == 3 and min(splits[:3]) > 1, splits
    assert splits[3] == 1, splits
    for _ in range(2):
        got = [attention.decode_attention_mxu(*c) for c in cases]
        for out, c in zip(got, cases):
            _assert_rows(out, attention.decode_attention_mxu_plain(*c))


def test_stacked_decode_every_layer_at_chunk_edges(dev):
    """Kernel 3 at every layer of a 4-layer stacked cache (7B heads),
    rows that end one short of a chunk, on its edge, one past it and at
    L, bf16 and int8: the layer is an offset into the cache."""
    g = torch.Generator(device=dev).manual_seed(21)
    nl, b, L, h, d = 4, 4, 832, 32, 128
    chunk, splits = attention.mha_split_plan(L, b, h,
                                             attention._sm_count(dev.index))
    assert splits > 2
    lens = torch.tensor([chunk - 1, chunk, chunk + 1, L], dtype=torch.int32,
                        device=dev)
    q = _rand(g, b, 1, h, d)
    for int8 in (False, True):
        if int8:
            kc, vc = (torch.randint(-127, 128, (nl, b, L, h, d), generator=g,
                                    device=dev, dtype=torch.int8)
                      for _ in range(2))
            ks, vs = (torch.rand((nl, b, L, h), generator=g, device=dev)
                      / 127 for _ in range(2))
        else:
            kc, vc = (_rand(g, nl, b, L, h, d) for _ in range(2))
            ks = vs = None
        for li in range(nl):
            before = cuda_lib.LAUNCHES["decode_attention_stacked"]
            got = attention.decode_attention_stacked(q, kc, vc, li, lens, ks,
                                                     vs)
            assert cuda_lib.LAUNCHES["decode_attention_stacked"] == before + 1
            _assert_rows(got, attention.decode_attention_stacked_plain(
                q, kc, vc, li, lens, ks, vs))


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
    (1, 100, 6, 2, 64, False), (1, 6240, 32, 4, 128, False),
    (1, 16384, 32, 4, 128, False), (1, 6240, 32, 8, 128, True),
    (1, 16384, 32, 8, 128, True), (1, 15, 8, 2, 32, False),
])
def test_gqa_decode_kernel_matches_plain(dev, b, L, h, h_kv, d, int8):
    """Kernel 11 (decode_attention_pallas): groups 4, 8, 1 and 12 (run as
    three blocks of 4 heads), any L (one chunk at L 15; 6,240 and 16,384
    past the old kernel's shared-memory cap), against the f32 plain
    version."""
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


@pytest.mark.parametrize("int8", [False, True])
def test_gqa_decode_rows_of_a_batch(dev, int8):
    """Kernel 11 on 4 rows of one cache of 2,048 at 32/8, d 128, with
    lengths {1, 700, 2048, 64}: rows that end in the first chunk, inside
    one, at the cache's end and on a chunk's edge, so most of the short
    rows' chunks are empty partials. Twice: the merge runs in split
    order, so the result is the same bits."""
    g = torch.Generator(device=dev).manual_seed(16)
    q = _rand(g, 4, 1, 32, 128)
    kc, vc, ks, vs = _flat_cache(g, dev, 4, 2048, 8, 128, int8)
    lens = torch.tensor([1, 700, 2048, 64], dtype=torch.int32, device=dev)
    got = attention.decode_attention_pallas(q, kc, vc, lens, ks, vs)
    again = attention.decode_attention_pallas(q, kc, vc, lens, ks, vs)
    _assert_rows(got, attention.decode_attention_pallas_plain(
        q, kc, vc, lens, ks, vs))
    assert torch.equal(got, again)


def test_gqa_decode_longest_cache(dev):
    """Kernel 11 has no length cap: the old kernel kept a score for every
    position in shared memory and raised past 6,239 positions at 32 query
    heads over 4, d 128. The split kernel's shared memory is bounded by
    its step, so a cache of 6,240 and one of 16,384 (which the JAX kernel
    takes too) each launch once and match the plain version."""
    g = torch.Generator(device=dev).manual_seed(15)
    q = _rand(g, 1, 1, 32, 128)
    for L in (6240, 16384):
        kc, vc, _, _ = _flat_cache(g, dev, 1, L, 4, 128, False)
        lens = torch.tensor([L], dtype=torch.int32, device=dev)
        before = cuda_lib.LAUNCHES["decode_attention_pallas"]
        got = attention.decode_attention_pallas(q, kc, vc, lens)
        assert cuda_lib.LAUNCHES["decode_attention_pallas"] == before + 1
        _assert_rows(got, attention.decode_attention_pallas_plain(
            q, kc, vc, lens))


def test_decode_fallthrough_on_the_card(dev):
    """The stacked and paged wrappers send the shapes kernels 3 and 10 do
    not take to the flat dispatch: a GQA cache to kernel 11, a paged pool
    of 24-position blocks or enable_paged_kernel(False) through the dense
    gather to kernel 9; under set_default_impl('xla') the stacked, paged
    and flat wrappers return the plain reference on CUDA tensors and
    launch nothing, as the JAX package's 'xla' runs its XLA twin on the
    accelerator."""
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
        dense16 = attention.paged_layer_dense(pool16, 1, table16)
        for run, cache in (
                (lambda: attention.decode_attention_stacked(q8, kv, kv, 1,
                                                            lens), kv[1]),
                (lambda: attention.decode_attention_paged(
                    q8, pool16, pool16, 1, table16, lens), dense16),
                (lambda: attention.decode_attention(q8, kv[1], kv[1], lens),
                 kv[1])):
            got = run()
            assert got.device == q8.device
            _assert_rows(got, attention.decode_attention_reference(
                q8, cache, cache, lens))
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
# batch, GQA, ragged right-aligned, non-causal, and every tile width; then
# the edges of the Hopper body's tiles (128 rows a block, 64 rows a
# streamed tile) at d 128 and 64, a causal diagonal that straddles a
# 128-row block, and the training layer's GQA 32/8 at full length
FLASH_SHAPES = [
    (1, 256, 256, 8, 8, 128, True), (2, 130, 130, 8, 2, 64, True),
    (1, 100, 137, 4, 4, 128, True), (2, 77, 50, 4, 2, 32, False),
    (1, 129, 129, 2, 1, 16, False), (1, 64, 96, 3, 3, 80, True),
    (1, 33, 33, 2, 2, 48, True), (1, 70, 70, 2, 2, 96, False),
    (1, 65, 65, 2, 2, 112, True),
    (1, 127, 127, 4, 4, 128, True), (1, 128, 128, 4, 2, 128, False),
    (1, 129, 129, 4, 4, 128, True), (1, 257, 257, 4, 4, 128, True),
    (1, 200, 333, 4, 4, 128, True), (1, 129, 200, 4, 2, 64, True),
    (1, 1024, 1024, 32, 8, 128, True),
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


# b, s, h, d of the audio path (non-causal): the Whisper large-v2
# encoder over two 30 s chunks, and the TL-TR head's time and layer
# transformers over 60 s (32 layers x 2 chunks x 3 windows of 25 tokens;
# 6 windows of 32 layer tokens)
AUDIO_FLASH_SHAPES = [(2, 1500, 20, 64), (192, 25, 4, 128), (6, 32, 4, 128)]


@pytest.mark.parametrize("b,s,h,d", AUDIO_FLASH_SHAPES)
def test_flash_forward_at_audio_shapes(dev, b, s, h, d):
    """Kernel 7 at the audio path's shapes, as multi_head_attention
    reaches it (the TL-TR head's q, k, v are strided slices of one fused
    product): absolute 2e-2 and 2^-6 of each (row, head)'s max |ref|
    against the plain forward, one launch."""
    gen = torch.Generator(device=dev).manual_seed(12)
    qkv = _rand(gen, b, s, 3, h, d)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    before = cuda_lib.LAUNCHES.get("flash_forward", 0)
    out = attention.multi_head_attention(q, k, v)
    assert cuda_lib.LAUNCHES["flash_forward"] == before + 1
    want, _ = attention.flash_forward_plain(q, k, v, False)
    _assert_close(out, want, 2e-2)
    err = (out.float() - want.float()).abs().amax(-1)
    assert (err / want.float().abs().amax(-1)).max().item() <= 2 ** -6


# Kernel 7's f32 body: Whisper base's encoder (one and two 30 s chunks),
# a ragged causal GQA pair, and the other head dims.
F32_FLASH_SHAPES = [(1, 1500, 1500, 8, 8, 64, False),
                    (2, 1500, 1500, 8, 8, 64, False),
                    (2, 100, 130, 8, 2, 128, True), (3, 77, 77, 4, 4, 48, False),
                    (2, 64, 64, 2, 2, 16, True), (1, 200, 260, 6, 3, 32, True),
                    (2, 65, 65, 3, 3, 80, False), (1, 130, 130, 2, 1, 96, True),
                    (1, 33, 90, 2, 2, 112, False)]


@pytest.mark.parametrize("b,sq,skv,h,h_kv,d,causal", F32_FLASH_SHAPES)
def test_flash_forward_f32_matches_plain(dev, b, sq, skv, h, h_kv, d,
                                         causal):
    """Kernel 7's f32 body against the plain forward: out and lse within
    2e-5 absolute (f32 on both sides, sums in another order), one launch
    counted as flash_forward_f32."""
    gen = torch.Generator(device=dev).manual_seed(14)
    q = _rand(gen, b, sq, h, d, dtype=torch.float32)
    k, v = (_rand(gen, b, skv, h_kv, d, dtype=torch.float32)
            for _ in range(2))
    before = cuda_lib.LAUNCHES["flash_forward_f32"]
    out, lse = attention.flash_forward(q, k, v, causal)
    assert cuda_lib.LAUNCHES["flash_forward_f32"] == before + 1
    want, want_lse = attention.flash_forward_plain(q, k, v, causal)
    assert out.dtype == torch.float32
    _assert_close(out, want, 2e-5)
    _assert_close(lse, want_lse, 2e-5)


def test_f32_attention_takes_the_f32_body(dev):
    """f32 CUDA operands (Whisper base as the chat CLI builds it) go from
    multi_head_attention to kernel 7's f32 body, decided before any
    launch; the TL-TR head's strided q, k, v slices are made contiguous
    first. One launch, no other kernel."""
    gen = torch.Generator(device=dev).manual_seed(13)
    qkv = _rand(gen, 1, 100, 3, 8, 64, dtype=torch.float32)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    before = dict(cuda_lib.LAUNCHES)
    out = attention.multi_head_attention(q, k, v)
    after = dict(cuda_lib.LAUNCHES)
    before["flash_forward_f32"] = before.get("flash_forward_f32", 0) + 1
    assert after == before
    want = attention.attention_reference(q, k, v)
    assert out.dtype == torch.float32
    _assert_close(out, want, 2e-5)


@pytest.mark.parametrize("d,dtype", [(64, torch.bfloat16),
                                     (32, torch.bfloat16),
                                     (64, torch.float32)])
def test_flash_kernels_past_65535_heads(dev, d, dtype):
    """b*h = 65,600 (b*h runs along the grid's x): kernel 7's Hopper body
    (d 64), its WMMA body (d 32) and its f32 body against the plain
    forward, and kernel 8 (bf16) against the plain backward, with the
    limits of test_flash_kernels_match_plain and
    test_flash_forward_f32_matches_plain."""
    gen = torch.Generator(device=dev).manual_seed(15)
    q, k, v, do = (_rand(gen, 16400, 16, 4, d, dtype=dtype)
                   for _ in range(4))
    out, lse = attention.flash_forward(q, k, v, True)
    want, want_lse = attention.flash_forward_plain(q, k, v, True)
    if dtype == torch.float32:
        _assert_close(out, want, 2e-5)
        _assert_close(lse, want_lse, 2e-5)
        return
    _assert_close(out, want, 2e-2)
    _assert_close(lse, want_lse, 1e-3)
    got = attention.flash_backward(q, k, v, out, lse, do, True)
    ref = attention.flash_backward_plain(q, k, v, out, lse, do, True)
    for a, r in zip(got, ref):
        _assert_rel(a, r, 2e-2)


@pytest.mark.parametrize("d", [24, 40])
def test_flash_kernels_at_head_dims_8_mod_16(dev, d):
    """d % 16 == 8, zero-padded to the next multiple of 16 with the
    unpadded d's scale: multi_head_attention's forward and gradient
    (kernels 7 and 8, bf16) against the plain versions at the limits of
    test_flash_kernels_match_plain, and the f32 body's forward at 2e-5;
    out and the gradients keep d columns."""
    gen = torch.Generator(device=dev).manual_seed(16)
    q, k, v, do = _flash_inputs(gen, 2, 70, 90, 4, 2, d)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = dict(cuda_lib.LAUNCHES)
    out = attention.multi_head_attention(*leaves, causal=True)
    out.backward(do)
    for name in ("flash_forward", "flash_backward_dq", "flash_backward_dkv"):
        assert cuda_lib.LAUNCHES[name] == before.get(name, 0) + 1, name
    want, lse = attention.flash_forward_plain(q, k, v, True)
    assert out.shape == want.shape
    _assert_close(out, want, 2e-2)
    ref = attention.flash_backward_plain(q, k, v, out.detach(), lse, do,
                                         True)
    for leaf, r in zip(leaves, ref):
        assert leaf.grad.shape == r.shape
        _assert_rel(leaf.grad, r, 2e-2)
    qf, kf, vf = (t.float() for t in (q, k, v))
    got, got_lse = attention.flash_forward(qf, kf, vf, True)
    want, want_lse = attention.flash_forward_plain(qf, kf, vf, True)
    assert got.shape == want.shape
    _assert_close(got, want, 2e-5)
    _assert_close(got_lse, want_lse, 2e-5)


@pytest.mark.parametrize("d", [256, 200])
def test_flash_kernels_at_head_dim_256(dev, d):
    """Head dims past 128 (d in (128, 256] zero-padded to 256, the WMMA
    and f32 bodies' slabs of 128 output columns along grid z):
    multi_head_attention's forward and gradient (kernels 7 and 8, bf16)
    against the plain versions at the limits of
    test_flash_kernels_match_plain, causal GQA and non-causal ragged, and
    the f32 body's forward at 2e-5; out and the gradients keep d
    columns."""
    gen = torch.Generator(device=dev).manual_seed(17)
    for b, sq, skv, h, h_kv, causal in ((2, 70, 90, 4, 2, True),
                                        (1, 130, 65, 2, 2, False)):
        q, k, v, do = _flash_inputs(gen, b, sq, skv, h, h_kv, d)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        before = dict(cuda_lib.LAUNCHES)
        out = attention.multi_head_attention(*leaves, causal=causal)
        out.backward(do)
        for name in ("flash_forward", "flash_backward_dq",
                     "flash_backward_dkv"):
            assert cuda_lib.LAUNCHES[name] == before.get(name, 0) + 1, name
        want, lse = attention.flash_forward_plain(q, k, v, causal)
        assert out.shape == want.shape
        _assert_close(out, want, 2e-2)
        err = (out.float() - want.float()).abs().amax(-1)
        assert (err / want.float().abs().amax(-1)).max().item() <= 2 ** -6
        ref = attention.flash_backward_plain(q, k, v, out.detach(), lse, do,
                                             causal)
        for leaf, r in zip(leaves, ref):
            assert leaf.grad.shape == r.shape
            _assert_rel(leaf.grad, r, 2e-2)
        qf, kf, vf = (t.float() for t in (q, k, v))
        before = cuda_lib.LAUNCHES["flash_forward_f32"]
        got, got_lse = attention.flash_forward(qf, kf, vf, causal)
        assert cuda_lib.LAUNCHES["flash_forward_f32"] == before + 1
        want, want_lse = attention.flash_forward_plain(qf, kf, vf, causal)
        assert got.shape == want.shape
        _assert_close(got, want, 2e-5)
        _assert_close(got_lse, want_lse, 2e-5)


# Kernel 8's f32 body (the SIMT body of csrc/flash_attention_simt.cuh):
# Whisper base's encoder shape, a ragged causal GQA pair, d 256 and a
# small head dim.
F32_BWD_SHAPES = [(1, 1500, 1500, 8, 8, 64, False),
                  (2, 100, 130, 8, 2, 128, True),
                  (1, 70, 90, 4, 2, 256, True), (2, 65, 65, 3, 3, 16, False)]


@pytest.mark.parametrize("b,sq,skv,h,h_kv,d,causal", F32_BWD_SHAPES)
def test_flash_backward_f32_matches_plain(dev, b, sq, skv, h, h_kv, d,
                                          causal):
    """Kernel 8 on f32 operands against the plain backward (fed the f32
    forward's out and lse): dq, dk, dv f32, each within 1e-5 of its
    tensor's max |ref| (f32 on both sides, sums in another order); one
    launch each, counted as flash_backward_dq_f32 and
    flash_backward_dkv_f32, and none of the bf16 body."""
    gen = torch.Generator(device=dev).manual_seed(18)
    q, k, v, do = (t.float() for t in
                   _flash_inputs(gen, b, sq, skv, h, h_kv, d))
    out, lse = attention.flash_forward(q, k, v, causal)
    before = dict(cuda_lib.LAUNCHES)
    got = attention.flash_backward(q, k, v, out, lse, do, causal)
    ran = {n: c - before.get(n, 0) for n, c in cuda_lib.LAUNCHES.items()
           if c != before.get(n, 0)}
    assert ran == {"flash_backward_dq_f32": 1, "flash_backward_dkv_f32": 1}
    ref = attention.flash_backward_plain(q, k, v, out, lse, do, causal)
    for a, r in zip(got, ref):
        assert a.dtype == r.dtype == torch.float32 and a.shape == r.shape
        _assert_rel(a, r, 1e-5)


@pytest.mark.parametrize("d", [384, 264, 512])
def test_flash_kernels_past_head_dim_256(dev, d):
    """Head dims past 256 (zero-padded to a multiple of 128, the SIMT
    body in slabs of 128 output columns): multi_head_attention's forward
    and gradient in bf16 (kernels 7 and 8) against the plain versions at
    the limits of test_flash_kernels_match_plain, and in f32 (the f32
    forward and backward) at 2e-5 absolute and 1e-5 of max |ref|; out and
    the gradients keep d columns."""
    gen = torch.Generator(device=dev).manual_seed(19)
    for b, sq, skv, h, h_kv, causal in ((2, 70, 90, 4, 2, True),
                                        (1, 130, 65, 2, 2, False)):
        q, k, v, do = _flash_inputs(gen, b, sq, skv, h, h_kv, d)
        for dtype in (torch.bfloat16, torch.float32):
            sfx = "_f32" if dtype == torch.float32 else ""
            leaves = [t.to(dtype).clone().requires_grad_()
                      for t in (q, k, v)]
            before = dict(cuda_lib.LAUNCHES)
            out = attention.multi_head_attention(*leaves, causal=causal)
            out.backward(do.to(dtype))
            for name in ("flash_forward", "flash_backward_dq",
                         "flash_backward_dkv"):
                name += sfx
                assert cuda_lib.LAUNCHES[name] == before.get(name, 0) + 1
            qd, kd, vd = (t.detach() for t in leaves)
            want, lse = attention.flash_forward_plain(qd, kd, vd, causal)
            assert out.shape == want.shape
            ref = attention.flash_backward_plain(qd, kd, vd, out.detach(),
                                                 lse, do.to(dtype), causal)
            if dtype == torch.float32:
                _assert_close(out, want, 2e-5)
                for leaf, r in zip(leaves, ref):
                    assert leaf.grad.shape == r.shape
                    _assert_rel(leaf.grad, r, 1e-5)
                continue
            _assert_close(out, want, 2e-2)
            err = (out.float() - want.float()).abs().amax(-1)
            assert (err / want.float().abs().amax(-1)).max().item() <= 2 ** -6
            for leaf, r in zip(leaves, ref):
                assert leaf.grad.shape == r.shape
                _assert_rel(leaf.grad, r, 2e-2)


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
    (4, 4096, 22016, 128), (3, 768, 256, 128), (8, 512, 384, 32),
    (2, 1024, 640, None), (5, 256, 128, None),
    # a tensor-parallel rank's wq/wk/wv and gate/up of Vicuna-7B (m = 2)
    (1, 4096, 2048, 128), (1, 4096, 5504, 128),
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
    (36, 4096, 22016, 128), (256, 4096, 22016, 128),
    (9, 512, 256, 32), (70, 768, 144, 128), (33, 1024, 256, None),
    (768, 4096, 2048, 128), (768, 4096, 5504, 128),
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


@pytest.mark.parametrize("d,f,group_size", [
    (256, 512, 128), (4096, 1024, 128), (512, 256, None),
])
def test_w4a16_matvec_every_nibble_exactly(dev, d, f, group_size):
    """The W4A16 matvec turns nibbles into floats by bit arithmetic: with
    q[k, f] = (k + f) % 16 - 8 every value -8..7 sits in the low and the
    high half, and a one-hot x picks row k, so y[f] = sw[g(k), f] q[k, f]
    exactly in f32 out (one product, every other term 0). A wrong magic
    constant or nibble order cannot pass."""
    g = torch.Generator(device=dev).manual_seed(22)
    k_idx = torch.arange(d, device=dev)[:, None]
    qv = (k_idx + torch.arange(f, device=dev)[None]) % 16 - 8  # (d, f)
    packed = quant4.pack_int4(qv)
    n_groups = d // group_size if group_size else 1
    scales = (torch.rand((n_groups, f), generator=g, device=dev)
              + 0.5).to(torch.bfloat16)
    rows = d // n_groups
    for k in sorted({0, 1, 5, d // 2 - 1, d // 2, d // 2 + 3, d - 1}):
        x = torch.zeros((1, d), device=dev, dtype=torch.bfloat16)
        x[0, k] = 1.0
        got = quant4.w4a16_matvec(x, packed, scales)
        torch.cuda.synchronize()
        want = scales[k // rows].float() * qv[k].float()
        assert torch.equal(got[0], want), k


@pytest.mark.parametrize("nb,d,f,group_size", [
    (768, 4096, 22016, 128), (2, 4096, 4096, 128), (36, 11008, 4096, 128),
    (9, 512, 256, 32), (70, 768, 144, 128), (33, 1024, 256, None),
    # each edge of w4a16_block_plan's row tiles (8, 16, 32, 48, 64, 128),
    # F = 4096 where the plan splits K, and 1100-row wo
    (8, 4096, 12288, 128), (9, 4096, 4096, 128), (16, 4096, 4096, 128),
    (17, 768, 256, 128), (64, 11008, 4096, 128), (65, 1024, 640, None),
    (128, 4096, 4096, 128), (129, 4096, 4096, 128), (256, 4096, 22016, 128),
    (1100, 4096, 4096, 128),
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


@pytest.mark.parametrize("nb,d,f,group_size", [
    (3, 256, 512, 128), (70, 4096, 4096, 128), (9, 512, 256, 32),
    (17, 512, 256, None), (129, 1024, 384, 128),
])
def test_w4a16_block_every_nibble_exactly(dev, nb, d, f, group_size):
    """The block matmul unpacks nibbles by bit arithmetic into wgmma's
    register fragments: with q[k, f] = (k + f) % 16 - 8 every value -8..7
    sits in the low and the high half, and row r of x one-hot at k_r picks
    row k_r, so y[r, f] = sw[g(k_r), f] q[k_r, f] exactly in f32 out (one
    product, every other term and every other group's fold 0). A wrong
    fragment order, nibble, group or half cannot pass."""
    g = torch.Generator(device=dev).manual_seed(23)
    qv = (torch.arange(d, device=dev)[:, None]
          + torch.arange(f, device=dev)[None]) % 16 - 8  # (d, f)
    packed = quant4.pack_int4(qv)
    n_groups = d // group_size if group_size else 1
    scales = (torch.rand((n_groups, f), generator=g, device=dev)
              + 0.5).to(torch.bfloat16)
    rows = d // n_groups
    ks = torch.tensor([0, 1, 5, d // 2 - 1, d // 2, d // 2 + 3, d - 1],
                      device=dev)
    k_of_row = ks[torch.arange(nb, device=dev) % len(ks)]
    x = torch.zeros((nb, d), device=dev, dtype=torch.bfloat16)
    x[torch.arange(nb, device=dev), k_of_row] = 1.0
    got = quant4.w4a16_block(x, packed, scales)
    torch.cuda.synchronize()
    want = scales[k_of_row // rows].float() * qv[k_of_row].float()
    assert torch.equal(got, want)


def test_w4a16_block_is_deterministic(dev):
    """The K splits' partials are added in split order, no atomics: two
    calls give the same bits (768-row down and 36-row gate_up split K,
    768-row gate_up does not)."""
    g = torch.Generator(device=dev).manual_seed(24)
    for nb, d, f in ((768, 11008, 4096), (36, 4096, 22016),
                     (768, 4096, 22016)):
        packed, scales = _int4_weight(g, d, f, 128)
        x = torch.randn(nb, d, generator=g, device=dev).to(torch.bfloat16)
        for out in (torch.float32, torch.bfloat16):
            first = quant4.w4a16_block(x, packed, scales, out)
            assert torch.equal(quant4.w4a16_block(x, packed, scales, out),
                               first), (nb, d, f, out)


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
    with pytest.raises(TypeError):  # bf16 or f32 only
        attention.flash_attention_bhsd(x.half(), x.half(), x.half())
    with pytest.raises(TypeError):  # mixed dtypes
        attention.flash_attention_bhsd(x.float(), x, x)
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
    with pytest.raises(TypeError):  # the flash kernels read bf16 or f32
        attention.flash_forward(qf.half(), qf.half(), qf.half())
    with pytest.raises(TypeError):  # one dtype for q, k and v
        attention.flash_forward(qf.float(), qf, qf)
    with pytest.raises(ValueError):  # causal needs sq <= skv
        attention.flash_forward(qf, qf[:, :4], qf[:, :4], causal=True)
    with pytest.raises(ValueError):  # 4 query heads over 3 kv heads
        kv3 = qf[:, :, :3].contiguous()
        attention.flash_forward(qf, kv3, kv3)
    q260 = _rand(g, 1, 8, 2, 260)
    with pytest.raises(ValueError):  # the kernels take d % 8 == 0 only
        attention.flash_forward(q260, q260, q260)
    with pytest.raises(ValueError):
        attention.flash_backward(q260, q260, q260, q260,
                                 torch.zeros((1, 2, 8), device=dev), q260)
    # d 264 is taken (padded to 384, the SIMT body): one forward launch
    q264 = _rand(g, 1, 8, 2, 264)
    before = cuda_lib.LAUNCHES["flash_forward"]
    out = attention.multi_head_attention(q264, q264, q264, causal=True)
    assert out.shape == q264.shape
    assert cuda_lib.LAUNCHES["flash_forward"] == before + 1


@pytest.mark.parametrize("shapes,q,b,nh,hd,p,dtype", [
    (((100, 100), (50, 50), (25, 25), (13, 13)), 900, 2, 8, 32, 4,
     torch.float32),
    (((12, 12), (6, 6), (3, 3)), 189, 1, 4, 64, 4, torch.bfloat16),
    (((10, 14), (5, 7)), 33, 3, 2, 128, 3, torch.float32),
    (((9, 9), (4, 4), (2, 2), (1, 1), (1, 1)), 17, 1, 8, 96, 6,
     torch.bfloat16),
    (((16, 16), (8, 8), (4, 4)), 336, 2, 4, 8, 4, torch.float32),
    (((7, 5), (3, 2)), 41, 2, 3, 40, 4, torch.bfloat16),
    # GroundingDINO's encoder (q = sum_hw) in both dtypes, and query counts
    # that are not a multiple of the vector path's 64-query tile
    (((100, 100), (50, 50), (25, 25), (13, 13)), 13294, 4, 8, 32, 4,
     torch.float32),
    (((100, 100), (50, 50), (25, 25), (13, 13)), 13294, 4, 8, 32, 4,
     torch.bfloat16),
    (((10, 14), (5, 7)), 45, 2, 8, 32, 4, torch.float32),
    (((10, 14), (5, 7)), 45, 2, 8, 32, 4, torch.bfloat16),
    (((6, 6), (3, 3)), 7, 1, 2, 16, 5, torch.float32),
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
    # deterministic: the lane groups' sums are added in a fixed order
    assert torch.equal(deformable.multi_scale_deformable_attention(
        value, shapes, locs, weights), got)
    deformable.set_default_impl("xla")  # the plain version, no launch
    try:
        before = sum(cuda_lib.LAUNCHES.values())
        plain = deformable.multi_scale_deformable_attention(value, shapes,
                                                            locs, weights)
        assert sum(cuda_lib.LAUNCHES.values()) == before
    finally:
        deformable.set_default_impl("auto")
    assert plain.device == value.device and torch.equal(plain, want)
    with pytest.raises(ValueError):  # more samples than a warp's lanes
        deformable.multi_scale_deformable_attention(
            value, shapes, torch.cat([locs] * 9, dim=4),
            torch.cat([weights] * 9, dim=4))
