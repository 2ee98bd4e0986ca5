"""Training entry point: projector (and embedding) tuning on precomputed
video features, on one GPU or sharded over a ('data', 'model') mesh.

Counterpart of video_llava_tpu/train/train.py, with its flags and
semantics: AdamW + warmup-cosine, a bf16 model, the trainable set of
--tune_mode (the frozen LLM optionally int8, --llm_weights), token-
weighted gradient accumulation, periodic checkpoints with a projector
export beside each, resume from the newest checkpoint-*, and the final
checkpoint, ``mm_projector.bin`` and ``train_summary.json``. It runs on
``--device`` (cuda unless told otherwise); random weights come from
--seed, the LLM's from --pretrained_dir when given (an HF LLaMA
directory).

Sharded (--mesh_data D, --mesh_model M): one process a rank, SPMD as the
JAX trainer runs under multi-host, every rank running this whole loop
(no driver): ranks from torchrun, else rank 0 spawns the others
(--dist_backend, --dist_init as the inference CLIs take them). Batch
rows on 'data' (each rank loads its shard of every global batch of
per_device x accumulation x D rows), the model tensor parallel over
'model' (parallel/sharding.py), and under --tune_mode full FSDP: the
free dim of every big matched kernel on 'data' too. The data axis
defaults to every rank but under --tune_mode full (as JAX's defaults to
every device). The first rank alone prints, writes the checkpoints (the
one-process format), the exports and the summary.

Run:
  python -m video_llava_tpu_torch.train.train --data_path data.json \\
      --video_folder feats/ --output_dir ckpts/ [--model_size 7b ...] \\
      [--mesh_data 2 --mesh_model 2 --dist_backend gloo]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from video_llava_tpu_torch.engine import weights
from video_llava_tpu_torch.engine.checkpoint import (
    export_projector,
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from video_llava_tpu_torch.models.video_llava import VideoLLaVA
from video_llava_tpu_torch.ops.attention import set_attention_mesh
from video_llava_tpu_torch.parallel import multihost
from video_llava_tpu_torch.parallel.mesh import make_mesh, mesh_shape
from video_llava_tpu_torch.parallel.sharding import shard_params
from video_llava_tpu_torch.runtime.model_init import (
    model_config,
    random_init_,
    random_init_quantized_llm_,
)
from video_llava_tpu_torch.runtime.tokenizer import load_tokenizer
from video_llava_tpu_torch.train.data import (
    Collator,
    LazySupervisedDataset,
    MultimodalCfg,
    sharded_data_iterator,
)
from video_llava_tpu_torch.train.train_step import (
    TUNE_MODES,
    init_train_state,
    make_optimizer,
    make_train_step,
    trainable_mask,
)

PROFILE_STEP = 3  # past the first steps' allocator and cuBLAS warm-up


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_path", required=True)
    p.add_argument("--video_folder", default=None)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--model_size", default="7b", choices=["7b", "13b", "tiny"])
    p.add_argument("--tokenizer_path", default=None)
    p.add_argument("--pretrained_dir", default=None,
                   help="HF LLaMA/Vicuna checkpoint dir: the LLM's weights")
    p.add_argument("--tune_mm_mlp_adapter", action="store_true", default=True,
                   help="accepted for the reference's command lines: the "
                   "projector always trains (--tune_mode sets the rest)")
    p.add_argument("--tune_mode", default="projector+embed",
                   choices=list(TUNE_MODES))
    p.add_argument("--learning_rate", type=float, default=2e-3)
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--warmup_ratio", type=float, default=0.03)
    p.add_argument("--num_train_epochs", type=int, default=3)
    p.add_argument("--per_device_train_batch_size", type=int, default=8)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--model_max_length", type=int, default=2048)
    p.add_argument("--save_steps", type=int, default=3000)
    p.add_argument("--mesh_data", type=int, default=None,
                   help="ranks along 'data' (batch rows; FSDP under "
                   "--tune_mode full); default: every rank, 1 under full")
    p.add_argument("--mesh_model", type=int, default=None,
                   help="ranks along 'model' (tensor parallel); default: "
                   "the ranks the data axis leaves")
    p.add_argument("--dist_backend", default="nccl",
                   choices=list(multihost.BACKENDS),
                   help="nccl: a card a rank; gloo: ranks may share a card, "
                   "and runs on the CPU")
    p.add_argument("--dist_init", default=None,
                   help="rendezvous of spawned ranks (tcp://localhost:PORT "
                   "or file://PATH); a free localhost port by default")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--profile", default=None, metavar="DIR",
                   help=f"write a torch.profiler trace of step "
                   f"{PROFILE_STEP} (past warm-up) into DIR/trace.json")
    p.add_argument("--llm_weights", default="bf16", choices=["bf16", "int8"],
                   help="weight format of the FROZEN LLM body: int8 halves "
                   "its memory; embed_tokens and the projector stay bf16")
    p.add_argument("--device", default="cuda",
                   help="torch device (cpu for tests and dry runs)")
    return p.parse_args(argv)


def build_model(args, cfg, device) -> VideoLLaVA:
    """bf16 VideoLLaVA with random weights from --seed (as
    runtime/model_init draws them), its LLM read from --pretrained_dir
    when given (an HF LLaMA directory, JAX train.py:120-128); with
    --llm_weights int8 every LLM linear is int8 (quantize_params'
    layout) and embed_tokens stays bf16, drawn or read and quantized one
    layer at a time on the device."""
    int8 = args.llm_weights == "int8"
    if int8 and args.tune_mode == "full":
        raise SystemExit("--llm_weights int8 requires a frozen LLM "
                         "(tune_mode projector/projector+embed)")
    model = VideoLLaVA(cfg, device=device, dtype=torch.bfloat16,
                       llm_quant="int8" if int8 else None,
                       llm_skip_keys=("embed_tokens",) if int8 else ())
    gen = torch.Generator(device=device).manual_seed(args.seed)
    if args.pretrained_dir:
        random_init_(model.vision, gen)
        random_init_(model.projector, gen)
        weights.convert_llama(weights.checkpoint_shards(args.pretrained_dir),
                              model.llm)
        return model
    random_init_(model, gen)
    if int8:
        random_init_quantized_llm_(model.llm, gen)
    return model


def build_sharded_model(args, cfg, device, mesh) -> VideoLLaVA:
    """build_model, then this rank's shard of it (FSDP under --tune_mode
    full). Ranks that share a card (gloo) take turns, so that one whole
    model at a time is on it; others build at once."""
    fsdp = args.tune_mode == "full"
    share = device.type == "cuda" and mesh.world > torch.cuda.device_count()
    for turn in range(mesh.world if share else 1):
        if not share or turn == multihost.get_rank():
            model = shard_params(build_model(args, cfg, device), mesh,
                                 fsdp=fsdp)
            if share:
                torch.cuda.empty_cache()
        if share:
            torch.distributed.barrier()
    return model


def _mesh_shape(args):
    """(world, data, model) of the run, checked before any rank starts:
    the world is torchrun's, else the flags' grid."""
    world = multihost.launched_world() or (
        (args.mesh_data or 1) * (args.mesh_model or 1))
    data = args.mesh_data or (world if args.tune_mode != "full" else 1)
    return (world,) + mesh_shape(data, args.mesh_model, world)


def main(argv=None) -> dict:
    args = parse_args(argv)
    world, data, model_axis = _mesh_shape(args)
    rank, device, procs = multihost.start_ranks(
        world, args.dist_backend, args.dist_init, args.device,
        entry=("video_llava_tpu_torch.train.train", "main"),
        argv=list(sys.argv[1:] if argv is None else argv))
    try:
        summary = train(args, device, data, model_axis)
    except BaseException:
        for p in procs:
            p.terminate()
        with contextlib.suppress(Exception):
            multihost.stop_ranks(procs, 5.0)
        raise
    multihost.stop_ranks(procs)
    return summary


def train(args, device, data: int, model_axis: int) -> dict:
    """The training loop on this rank (the whole run on one)."""
    first = multihost.is_main_process()
    say = print if first else (lambda *a, **k: None)
    tokenizer = load_tokenizer(args.tokenizer_path)
    cfg = dataclasses.replace(
        model_config(args.model_size),
        vid_patch_token_id=tokenizer.vid_patch_token_id,
        vid_start_token_id=tokenizer.vid_start_token_id,
        vid_end_token_id=tokenizer.vid_end_token_id,
    )
    mesh = make_mesh(data, model_axis)
    if mesh.world > 1:
        model = build_sharded_model(args, cfg, device, mesh)
        set_attention_mesh(mesh)
    else:
        mesh = None
        model = build_model(args, cfg, device)

    dataset = LazySupervisedDataset(
        args.data_path, tokenizer,
        MultimodalCfg(video_token_len=cfg.video_token_len,
                      video_folder=args.video_folder,
                      use_vid_start_end=cfg.use_vid_start_end),
        max_len=args.model_max_length)
    collator = Collator(tokenizer.pad_token_id, max_len=args.model_max_length)
    batch_size = (args.per_device_train_batch_size
                  * args.gradient_accumulation_steps * data)
    steps_per_epoch = max(len(dataset) // batch_size, 1)
    total_steps = steps_per_epoch * args.num_train_epochs

    trainable = trainable_mask(model, args.tune_mode)
    tx = make_optimizer(args.learning_rate, args.weight_decay,
                        warmup_steps=int(total_steps * args.warmup_ratio),
                        total_steps=total_steps)
    state = init_train_state(model, tx, trainable)

    start_step = 0
    resume = latest_checkpoint(args.output_dir)
    if resume:
        say(f"resuming from {resume}")
        state = restore_checkpoint(resume, state)
        start_step = state.step

    step_fn = make_train_step(tx, grad_accum=args.gradient_accumulation_steps,
                              mesh=mesh)
    rng = np.random.default_rng(args.seed)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    log = {"loss": [], "grad_norm": [], "step_s": [], "tokens": [],
           "bucket": []}

    step = start_step
    t0 = time.time()
    for epoch in range(args.num_train_epochs):
        for batch in sharded_data_iterator(dataset, collator, batch_size,
                                           rng, device, mesh=mesh):
            if step - start_step == 0:
                say("first batch shapes: "
                    f"{ {k: tuple(v.shape) for k, v in batch.items()} }")
            t_step = time.perf_counter()
            if (args.profile and first
                    and step - start_step == PROFILE_STEP):
                os.makedirs(args.profile, exist_ok=True)
                activities = [ProfilerActivity.CPU] + (
                    [ProfilerActivity.CUDA] if device.type == "cuda" else [])
                with profile(activities=activities) as prof:
                    state, metrics = step_fn(state, batch)
                    sync()
                trace = os.path.join(args.profile, "trace.json")
                prof.export_chrome_trace(trace)
                say(f"profiler trace written to {trace}")
            else:
                state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])  # waits for the step's end
            log["step_s"].append(time.perf_counter() - t_step)
            log["loss"].append(loss)
            log["grad_norm"].append(float(metrics["grad_norm"]))
            tokens = torch.tensor([batch["input_ids"].numel()],
                                  device=device)
            if mesh is not None:  # the global batch's
                mesh.all_sum(tokens, "data")
            log["tokens"].append(int(tokens[0]))
            log["bucket"].append(int(batch["input_ids"].shape[1]))
            step += 1
            if step % 10 == 0:
                dt = time.time() - t0
                say(f"epoch {epoch} step {step}/{total_steps} "
                    f"loss {loss:.4f} "
                    f"({dt / max(step - start_step, 1):.2f}s/step)")
            if args.save_steps and step % args.save_steps == 0:
                save_checkpoint(args.output_dir, step, state)
                export_projector(model, os.path.join(
                    args.output_dir, "mm_projector", f"checkpoint-{step}.bin"))

    sync()
    wall_s = time.time() - t0
    t_save = time.perf_counter()
    save_checkpoint(args.output_dir, step, state)
    export_projector(model, os.path.join(args.output_dir, "mm_projector.bin"))
    summary = {"steps": step, "wall_s": wall_s,
               "save_s": time.perf_counter() - t_save,
               "mesh": [data, model_axis], **log}
    if first:
        with open(os.path.join(args.output_dir, "train_summary.json"),
                  "w") as f:
            json.dump(summary, f)
    say("training complete")
    return summary


if __name__ == "__main__":
    main()
