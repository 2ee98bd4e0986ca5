"""The launch plans of kernels A and B (ops/quant4.py
matvec_rows_per_split, w4a8_block_plan) at Vicuna-7B's linears and at the
GPU tests' odd shapes: every packed row is reduced by exactly one split,
no split cuts a scale group, each launch's shared memory fits the H100's
227 KB, and the rows tile and the splits follow nb and the card."""

from video_llava_tpu_torch.ops import quant4

SM_COUNT = 132  # the H100 SXM
LINEARS_7B = {"wqkv": (4096, 3 * 4096), "wo": (4096, 4096),
              "gate_up": (4096, 2 * 11008), "down": (11008, 4096)}
ODD_A = ((3, 768, 256, 128), (8, 512, 384, 32), (2, 1024, 640, None),
         (5, 256, 128, None))
ODD_B = ((9, 512, 256, 32), (70, 768, 144, 128), (33, 1024, 256, None),
         (768, 4096, 22016, 128), (1100, 4096, 4096, 128))


def _splits(dh, rows):
    """The [start, end) packed-row ranges the kernels' blocks take."""
    return [(k, min(k + rows, dh)) for k in range(0, dh, rows)]


def _check_cover(dh, n_groups, rows, unit):
    gr = dh if n_groups == 1 else 2 * dh // n_groups
    ranges = _splits(dh, rows)
    covered = [0] * dh
    for k0, k1 in ranges:
        for k in range(k0, k1):
            covered[k] += 1
    assert covered == [1] * dh, (dh, rows)
    if len(ranges) > 1:
        assert rows % unit == 0, (rows, unit)
        if n_groups > 1:  # every split starts at a group's first row
            assert all(k0 % gr == 0 for k0, _ in ranges), (rows, gr)
    return len(ranges)


def test_w4a8_plans():
    cases = [(nb, d, f, 128) for d, f in LINEARS_7B.values()
             for nb in (1, 4, 8, 36, 256, 768, 1100)]
    for nb, d, f, g in cases + list(ODD_A) + list(ODD_B):
        dh = d // 2
        n_groups = d // (g or d)
        if nb <= quant4.MATVEC_MAX_ROWS:  # kernel A
            rows = quant4.matvec_rows_per_split(dh, f, n_groups, SM_COUNT)
            splits = _check_cover(dh, n_groups, rows, quant4.MATVEC_STEP)
            assert (quant4.matvec_smem_bytes(rows, dh, n_groups)
                    <= quant4.SMEM_LIMIT), (nb, d, f, rows)
            tiles = -(-f // quant4.MATVEC_COLS)
            # the target blocks an SM where K has the units for it, within
            # the rounding of whole units a split (at most a factor of 2)
            unit = quant4._split_unit(dh, n_groups, quant4.MATVEC_STEP)
            units = -(-dh // unit)
            target = -(-quant4.MATVEC_BLOCKS_PER_SM * SM_COUNT // tiles)
            assert 2 * splits >= min(target, units), (nb, d, f, rows)
            assert splits <= max(target, 1), (nb, d, f, rows)
        # kernel B (past 8 rows on the path; any nb is valid)
        rows_tile, rows = quant4.w4a8_block_plan(nb, dh, f, n_groups,
                                                 SM_COUNT)
        assert rows_tile == (64 if nb <= 64 else 128), (nb, rows_tile)
        _check_cover(dh, n_groups, rows, quant4.BLOCK_STEP)
        assert rows % quant4.BLOCK_STEP == 0 or rows >= dh
        smem = quant4.block_smem_bytes(rows_tile)
        assert smem <= quant4.SMEM_LIMIT, (nb, d, f, smem)
        # the output tile is staged in the ring's bytes, 68 floats a row
        assert (2 * rows_tile * 68 * 4
                <= quant4.BLOCK_STAGES * quant4.block_stage_bytes(rows_tile))
    # the chat's 768-row prefill fills the card with output tiles alone;
    # serving's 36-row verify splits K to even out its 1.3 waves
    assert quant4.w4a8_block_plan(768, 2048, 22016, 32, SM_COUNT)[1] == 2048
    assert quant4.w4a8_block_plan(36, 2048, 22016, 32, SM_COUNT)[1] < 2048
