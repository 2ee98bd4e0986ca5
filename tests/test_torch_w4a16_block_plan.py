"""The launch plan of the W4A16 block matmul (ops/quant4.py
w4a16_block_plan) at Vicuna-7B's four linears and at 2, 8, 36, 256, 768
and 1100 rows, and at the GPU tests' odd shapes: the row tile is the
smallest that holds the rows (128-row tiles past 128), every packed row is
reduced by exactly one split, no split cuts a scale group, the ring and
the staged output tile fit the H100's 227 KB, and the K splits are the
ones the card measured fastest (PERF.md §6)."""

from video_llava_tpu_torch.ops import quant4

SM_COUNT = 132  # the H100 SXM
LINEARS_7B = {"wqkv": (4096, 3 * 4096), "wo": (4096, 4096),
              "gate_up": (4096, 2 * 11008), "down": (11008, 4096)}
ODD = ((9, 512, 256, 32), (70, 768, 144, 128), (33, 1024, 256, None),
       (17, 768, 256, 128), (65, 1024, 640, None), (129, 1024, 384, 128))


def test_w4a16_block_plans():
    cases = [(nb, d, f, 128) for d, f in LINEARS_7B.values()
             for nb in (2, 8, 36, 256, 768, 1100)]
    for nb, d, f, group in cases + list(ODD):
        dh = d // 2
        n_groups = d // (group or d)
        gr = dh if n_groups == 1 else 2 * dh // n_groups
        tile, stages, rows = quant4.w4a16_block_plan(nb, dh, f, n_groups,
                                                     SM_COUNT)
        tiles = quant4.W4A16_ROW_TILES
        assert tile in tiles, (nb, tile)
        # the smallest tile that holds nb rows, 128-row tiles past 128
        assert tile >= nb or tile == tiles[-1], (nb, tile)
        assert all(t < nb for t in tiles if t < tile), (nb, tile)
        # every packed row in exactly one split; splits of whole 128-row
        # steps, each starting at a scale group's first row
        ranges = [(k, min(k + rows, dh)) for k in range(0, dh, rows)]
        covered = [0] * dh
        for k0, k1 in ranges:
            for k in range(k0, k1):
                covered[k] += 1
        assert covered == [1] * dh, (nb, d, f, rows)
        if len(ranges) > 1:
            assert rows % quant4.W4A16_BLOCK_STEP == 0, (nb, d, f, rows)
            if n_groups > 1:
                assert all(k0 % gr == 0 for k0, _ in ranges), (rows, gr)
        # the ring of `stages` stages fits, one more would not (or the
        # plan's cap), and the epilogue's two f32 tiles fit in the ring
        smem = quant4.w4a16_block_smem_bytes(tile, stages)
        assert 2 <= stages <= quant4.W4A16_MAX_STAGES
        assert smem <= quant4.SMEM_LIMIT, (nb, d, f, smem)
        assert (stages == quant4.W4A16_MAX_STAGES
                or quant4.w4a16_block_smem_bytes(tile, stages + 1)
                > quant4.SMEM_LIMIT), (tile, stages)
        assert 2 * tile * 68 * 4 <= (stages
                                     * quant4.w4a16_block_stage_bytes(tile))
    # the splits the card measured fastest (w4a8_sweep.py W4A16)
    splits = lambda nb, d, f: -(-(d // 2) // quant4.w4a16_block_plan(  # noqa
        nb, d // 2, f, d // 128, SM_COUNT)[2])
    assert splits(768, 4096, 22016) == 1  # the chat prefill's gate_up
    assert splits(256, 4096, 22016) == 1
    assert splits(768, 11008, 4096) == 2  # down: 32 column tiles
    assert splits(36, 11008, 4096) == 4
    assert splits(36, 4096, 22016) == 2
    assert splits(2, 4096, 22016) == 2
    assert splits(8, 4096, 4096) == 4
