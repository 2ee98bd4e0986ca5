#!/usr/bin/env python3
"""Time kernels A and B (the W4A8 int4 matvec and block matmul) and the
W4A16 block matmul on one CUDA card under their plan's choices, on
Vicuna-7B's linears.

    python3 w4a8_sweep.py [A] [B] [W4A16] [--plan-only]

A: the matvec at each blocks-an-SM target of its K split
(quant4.MATVEC_BLOCKS_PER_SM, 1 to 6), at wqkv and down (one row), gate_up
(4 rows: serving's decode) and wo, bf16 out; wqkv and gate_up also from
HBM (one call on each of 4 layer copies, past the 50 MB L2). B: the block
matmul under its plan (w4a8_block_plan) and under each forced choice of K
splits (1, 2, 4) and rows tile (64, 128), at 768, 256 and 36 rows of
gate_up, 768 of down and 1100 of wo. W4A16: the W4A16 block matmul under
its plan (w4a16_block_plan) and under each forced rows tile (the plan's
and its neighbours in W4A16_ROW_TILES) and K splits (1, 2, 4, 8), at 768,
256, 36 and 2 rows of gate_up, 768 and 36 of down, 8 of wo and 2 of wqkv.
Each line gives the
replayed device ms a call (chip_smoke.median_ms: a CUDA graph of 10 calls,
the median of 7 replays) and max|err| / max|ref| against the plain
version. --plan-only times each kernel at its plan alone. Run from the
repository's root; it needs a card and prints its name and power limit
first.
"""

from __future__ import annotations

import sys

import torch

import chip_smoke as cs
from video_llava_tpu_torch.ops import cuda_lib, quant4

LINEARS = {"wqkv": (4096, 3 * 4096), "gate_up": (4096, 2 * 11008),
           "down": (11008, 4096), "wo": (4096, 4096)}


def main(argv) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("w4a8_sweep: no CUDA device")
    plan_only = "--plan-only" in argv
    kinds = set(a for a in argv if a != "--plan-only") or {"A", "B",
                                                             "W4A16"}
    dev = torch.device("cuda:0")
    print(f"card: {cs.card_line()}", flush=True)
    cuda_lib.library()
    g = torch.Generator(device=dev).manual_seed(0)
    weights = {}
    for key, (d, f) in LINEARS.items():
        w = torch.randn(4, d, f, generator=g, device=dev) * d ** -0.5
        weights[key] = quant4.quantize_tensor_int4(w, 128)

    def run(name, nb, key, label, hbm=False):
        pk, sc = weights[key]
        x = torch.randn(nb, 2 * pk.shape[1], generator=g,
                        device=dev).to(torch.bfloat16)
        kernel = getattr(quant4, name)
        plain = {"w4a8_matvec": quant4.int4_matmul_w4a8_xla,
                 "w4a8_block": quant4.int4_matmul_w4a8_block_xla,
                 "w4a16_block": quant4.int4_matmul_w4a16_block_plain}[name]
        p, s = pk[2], sc[2]
        got = kernel(x, p, s, torch.bfloat16).float()
        want = plain(x, p, s).to(torch.bfloat16).float()
        rel = ((got - want).abs().max() / want.abs().max()).item()
        ms = cs.median_ms(lambda: kernel(x, p, s, torch.bfloat16))
        line = (f"{name} {label} ({nb}, {key}, bf16 out): {ms:.4f} ms, "
                f"max|err|/max|ref| {rel:.2e}")
        if hbm:
            ms_hbm = cs.rotating_ms([
                lambda li=li: kernel(x, pk[li], sc[li], torch.bfloat16)
                for li in range(len(pk))])
            line += f", ms_hbm {ms_hbm:.4f} over {len(pk)} copies"
        print(line, flush=True)

    with torch.inference_mode():
        if "A" in kinds:
            default = quant4.MATVEC_BLOCKS_PER_SM
            for bps in ((default,) if plan_only
                        else (default, 1, 2, 3, 4, 5, 6, default)):
                quant4.MATVEC_BLOCKS_PER_SM = bps
                for nb, key in ((1, "wqkv"), (4, "gate_up"), (1, "down"),
                                (1, "wo")):
                    run("w4a8_matvec", nb, key, f"blocks/SM {bps}",
                        hbm=key in ("wqkv", "gate_up"))
            quant4.MATVEC_BLOCKS_PER_SM = default
        if "B" in kinds:
            plan = quant4.w4a8_block_plan
            try:
                for nb, key in ((768, "gate_up"), (256, "gate_up"),
                                (36, "gate_up"), (768, "down"),
                                (1100, "wo")):
                    quant4.w4a8_block_plan = plan
                    dh, f = weights[key][0].shape[1:]
                    run("w4a8_block", nb, key,
                        f"plan {plan(nb, dh, f, 2 * dh // 128, 132)}")
                    for splits in () if plan_only else (1, 2, 4):
                        for tile in (64, 128):
                            if tile == 64 and nb > 256:
                                continue
                            rows = quant4._split_rows(dh, quant4.BLOCK_STEP,
                                                      splits)
                            quant4.w4a8_block_plan = (
                                lambda *_, t=tile, r=rows: (t, r))
                            run("w4a8_block", nb, key,
                                f"splits {-(-dh // rows)} tile {tile}")
            finally:
                quant4.w4a8_block_plan = plan
        if "W4A16" in kinds:
            plan = quant4.w4a16_block_plan
            tiles = quant4.W4A16_ROW_TILES
            try:
                for nb, key in ((768, "gate_up"), (256, "gate_up"),
                                (36, "gate_up"), (2, "gate_up"),
                                (768, "down"), (36, "down"), (8, "wo"),
                                (2, "wqkv")):
                    quant4.w4a16_block_plan = plan
                    dh, f = weights[key][0].shape[1:]
                    chosen = plan(nb, dh, f, 2 * dh // 128, 132)
                    run("w4a16_block", nb, key, f"plan {chosen}")
                    i = tiles.index(chosen[0])
                    for tile in () if plan_only else tiles[max(0, i - 1):i + 2]:
                        stages = max(
                            n for n in range(2, quant4.W4A16_MAX_STAGES + 1)
                            if quant4.w4a16_block_smem_bytes(tile, n)
                            <= quant4.SMEM_LIMIT)
                        for splits in (1, 2, 4, 8):
                            rows = quant4._split_rows(
                                dh, quant4.W4A16_BLOCK_STEP, splits)
                            quant4.w4a16_block_plan = (
                                lambda *_, t=tile, n=stages, r=rows: (t, n, r))
                            run("w4a16_block", nb, key,
                                f"tile {tile} stages {stages} splits "
                                f"{-(-dh // rows)}")
            finally:
                quant4.w4a16_block_plan = plan
    print(f"card: {cs.card_line()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
