"""One sharded training step, then sharded greedy decode, over n ranks.

Counterpart of the JAX package's dryrun_multichip (its driver entry's
sharded train step and decode check): n ranks (processes over gloo,
sharing the device when it is a card) on a ('data', 'model') mesh of 2 x
n/2 (1 x n for odd n), the tiny f32 configuration (vocab 512, hidden 64,
2 layers of 8 heads of 8) with random weights from --seed, FSDP
parameter sharding and projector+embed tuning: one train step on a batch
of 2 rows a data shard (its loss must be finite), and greedy decode of 8
tokens on the same mesh, each data row of ranks decoding its own rows,
which must equal one process's decode of the whole batch token for
token. The decode runs on the weights before the step.

Usage: python -m video_llava_tpu_torch.scripts.dryrun_multichip
       [--ranks 4] [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import sys

import numpy as np
import torch

from video_llava_tpu_torch.config import (
    GenerationConfig,
    LlamaConfig,
    VideoLLaVAConfig,
)
from video_llava_tpu_torch.constants import IGNORE_INDEX
from video_llava_tpu_torch.engine.generate import generate
from video_llava_tpu_torch.models.video_llava import VideoLLaVA
from video_llava_tpu_torch.ops.attention import set_attention_mesh
from video_llava_tpu_torch.parallel import multihost
from video_llava_tpu_torch.parallel.mesh import make_mesh
from video_llava_tpu_torch.parallel.sharding import shard_params
from video_llava_tpu_torch.runtime.model_init import random_init_
from video_llava_tpu_torch.train.train_step import (
    init_train_state,
    make_optimizer,
    make_train_step,
    trainable_mask,
)


def tiny_cfg() -> VideoLLaVAConfig:
    return dataclasses.replace(
        VideoLLaVAConfig.tiny(),
        llm=LlamaConfig(vocab_size=512, hidden_size=64,
                        intermediate_size=256, num_layers=2, num_heads=8,
                        num_kv_heads=8, head_dim=8),
        vid_patch_token_id=259, vid_start_token_id=260,
        vid_end_token_id=261)


def batch(cfg: VideoLLaVAConfig, b: int, s: int = 160):
    """The dryrun's seeded batch: random ids with the patch block at 4,
    the last 16 positions as targets, normal features."""
    n = cfg.video_token_len
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 256, size=(b, s))
    ids[:, 4:4 + n] = cfg.vid_patch_token_id
    labels = np.full((b, s), IGNORE_INDEX, np.int64)
    labels[:, -16:] = rng.integers(0, 256, size=(b, 16))
    feats = rng.normal(size=(b, n, cfg.vision.hidden_size))
    return {"input_ids": torch.from_numpy(ids.astype(np.int32)),
            "labels": torch.from_numpy(labels.astype(np.int32)),
            "video_features": torch.from_numpy(feats.astype(np.float32))}


def mesh_grid(n: int):
    data = 2 if n % 2 == 0 and n > 1 else 1
    return data, n // data


def run(n: int, device, seed: int = 0) -> dict:
    """This rank's part of the dryrun -> {"loss", "match", "mesh"}."""
    data, model_axis = mesh_grid(n)
    mesh = make_mesh(data, model_axis)
    cfg = tiny_cfg()
    model = VideoLLaVA(cfg, device=device, dtype=torch.float32)
    random_init_(model, torch.Generator(device=device).manual_seed(seed))
    b, s = 2 * data, 160
    full = {k: v.to(device) for k, v in batch(cfg, b, s).items()}
    lens = torch.tensor([s] * (b - 1) + [s - 7], dtype=torch.int32,
                        device=device)
    gen = GenerationConfig(max_new_tokens=8, do_sample=False,
                           eos_token_id=-1, pad_token_id=0)
    with torch.inference_mode():  # one process's decode of every row
        want = generate(model, gen, full["input_ids"], lens,
                        full["video_features"], cache_dtype=torch.float32)
    shard_params(model, mesh, fsdp=True)
    set_attention_mesh(mesh)
    d = mesh.coords["data"]
    rows = slice(d * (b // data), (d + 1) * (b // data))
    local = {k: v[rows] for k, v in full.items()}
    with torch.inference_mode():
        got = generate(model, gen, local["input_ids"], lens[rows],
                       local["video_features"], cache_dtype=torch.float32)
    match = (torch.equal(got.tokens, want.tokens[rows])
             and torch.equal(got.lengths, want.lengths[rows]))

    tx = make_optimizer(1e-3, total_steps=10, warmup_steps=0)
    state = init_train_state(model, tx,
                             trainable_mask(model, "projector+embed"))
    _, metrics = make_train_step(tx, mesh=mesh)(state, local)
    return {"loss": float(metrics["loss"]), "match": bool(match),
            "mesh": [data, model_axis]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="every rank's device (ranks share one card over "
                    "gloo); cpu for a run without one")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dist_init", default=None)
    args = ap.parse_args(argv)
    rank, device, procs = multihost.start_ranks(
        args.ranks, "gloo", args.dist_init, args.device,
        entry=("video_llava_tpu_torch.scripts.dryrun_multichip", "main"),
        argv=list(sys.argv[1:] if argv is None else argv))
    try:
        mine = run(args.ranks, device, args.seed)
        every = multihost.all_gather_objects(mine)
    except BaseException:
        for p in procs:
            p.terminate()
        raise
    multihost.stop_ranks(procs)
    out = {"mesh": mine["mesh"], "loss": every[0]["loss"],
           "losses": [r["loss"] for r in every],
           "decode_match": all(r["match"] for r in every)}
    if rank == 0:
        print(f"dryrun_multichip train: mesh={out['mesh']}, "
              f"loss={out['loss']:.4f}")
        print(f"dryrun_multichip decode parity: "
              f"{'OK' if out['decode_match'] else 'FAILED'}")
    if not all(math.isfinite(x) for x in out["losses"]):
        raise SystemExit(f"non-finite loss: {out['losses']}")
    if not out["decode_match"]:
        raise SystemExit("sharded decode diverges from one process")
    return out


if __name__ == "__main__":
    main()
