"""portbench/flops.py against hand counts at the shapes of PERF.md's
kernel table (its bounds were computed by hand there)."""

import math

from portbench import flops, run
from portbench.tests import tiny


def test_clip_attention_bound():
    # kernel 1, 100 frames x 16 heads, 257 keys padded to 272: bytes
    nbytes, ops = flops.clip_attn_call(100 * 16, 272, 257, 64)
    assert nbytes == (2 * 272 + 2 * 257) * 1600 * 64 * 2
    assert ops == 4 * 1600 * 272 * 257 * 64
    assert math.isclose(flops.bound_s(nbytes, ops, "bf16") * 1e3, 0.0647,
                        abs_tol=5e-5)
    # 336 px: 577 keys padded to 640, bound by operations
    nbytes, ops = flops.clip_attn_call(1600, 640, 577, 64)
    assert math.isclose(flops.bound_s(nbytes, ops, "bf16") * 1e3, 0.1529,
                        abs_tol=5e-5)
    assert flops.clip_padded_length(257) == 272
    assert flops.clip_padded_length(577) == 640


def test_w4a8_block_bound():
    # kernel B, Vicuna-7B's fused gate_up at 768 rows: 0.0700 ms by ops
    nbytes, ops = flops.w4a8_block_call(768, 4096, 2 * 11008)
    assert ops == 2 * 768 * 4096 * 22016
    assert nbytes == 2048 * 22016 + 2 * 32 * 22016 + 2 * 768 * 4096 \
        + 768 * 22016 * 2
    assert math.isclose(flops.bound_s(nbytes, ops, "int8") * 1e3, 0.0700,
                        abs_tol=5e-5)
    # down at 768 rows: 0.0350 ms
    nbytes, ops = flops.w4a8_block_call(768, 11008, 4096)
    assert math.isclose(flops.bound_s(nbytes, ops, "int8") * 1e3, 0.0350,
                        abs_tol=5e-5)


def test_qa_batch_ops_by_hand():
    cfg = tiny.cfg()
    v = cfg["vision_config"]
    frames, s, answer = 4, 30, 3
    ops = flops.qa_batch_ops(cfg, frames, [s], answer)
    n, d, f = 5, 64, 128  # 4 patches + CLS
    clip = frames * (v["num_hidden_layers"] - 1) * (
        2 * n * (4 * d * d + 2 * d * f) + 4 * n * n * d)
    proj = 2 * (4 + 4) * 64 * 256
    layer = 256 * 256 + 2 * 256 * 128 + 256 * 256 + 3 * 256 * 512
    head = 2 * 256 * 1006
    decode_attn = sum(4 * 4 * 64 * (s + t) * 2 for t in (1, 2))
    assert ops["bf16"] == clip + proj + head * answer + decode_attn
    assert ops["int8"] == 2 * layer * 2 * (s + answer - 1)
    assert ops["f32"] == (frames * 2 * 4 * 588 * 64
                          + 2 * 4 * 64 * s * (s + 1) * 2)
    assert flops.peak_seconds({"bf16": 989e12, "int8": 1979e12}) == 2.0
    # the roofline readers' bounds of a batch of 2 videos, 32 padded rows
    clip = run.reader("clip_attn_roofline").batch_bound(v, 2 * frames)
    nbytes, ops = flops.clip_attn_call(2 * frames * 4, 16, n, 16)
    assert clip == (v["num_hidden_layers"] - 1) * flops.bound_s(
        nbytes, ops, "bf16")
    block = run.reader("w4a8_block_roofline").batch_bound(cfg, 2 * 32)
    shapes = [(256, 256), (256, 128), (256, 128), (256, 256), (256, 512),
              (256, 512), (512, 256)]
    assert math.isclose(block, 2 * sum(
        flops.bound_s(*flops.w4a8_block_call(64, i, o), "int8")
        for i, o in shapes), rel_tol=1e-12)
    flash = run.reader("flash_train_roofline").step_bound(cfg, 2, 32)
    calls = flops.flash_calls(2, 32, 4, 2, 64)
    assert math.isclose(flash, 2 * (2 * flops.bound_s(*calls["fwd"], "bf16")
                                     + flops.bound_s(*calls["dq"], "bf16")
                                     + flops.bound_s(*calls["dkv"], "bf16")),
                        rel_tol=1e-12)
