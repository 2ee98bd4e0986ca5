"""Serve a Vicuna judge / video chat endpoint from the command line.

Counterpart of video_llava_tpu/serving/__main__.py, with its flags and
defaults:

    python -m video_llava_tpu_torch.serving --model_size 7b --quant int4 \
        --continuous --paged

Random weights unless --model_name names a checkpoint directory, on the
card. --quant int8 also takes an int8 KV cache. --batching runs the
windowed batcher with its --max_batch and --window_ms (which reach
serve() here; the JAX CLI parses them and drops them, so its batcher
always runs at 8 and 30 ms).

--mesh_model m serves tensor parallel over m ranks (parallel/): rank 0
runs the HTTP server and the other ranks follow its engine calls
(parallel/driver.py). Under torchrun each rank runs this command; else
this process is rank 0 and spawns the others. --dist_backend nccl takes
a card a rank; gloo lets ranks share a card (and runs on the CPU, with
--device cpu). --dist_init names the rendezvous (tcp://localhost:<port>
or file://<path>; a free localhost port by default). As in the JAX CLI,
a mesh turns the fused wqkv/gate_up layout off.
"""

from __future__ import annotations

import argparse
import sys

import torch

from video_llava_tpu_torch.engine.quant_select import resolve_quant
from video_llava_tpu_torch.parallel import driver
from video_llava_tpu_torch.runtime.model_init import (
    dtype_kwargs,
    initialize_model,
)
from video_llava_tpu_torch.serving.server import ChatModel, serve


def main(argv=None):
    ap = argparse.ArgumentParser(prog="video_llava_tpu_torch.serving")
    ap.add_argument("--model_name", default=None,
                    help="HF Vicuna checkpoint directory (tokenizer and "
                    "LLM weights; random weights without one)")
    ap.add_argument("--model_size", default="13b",
                    choices=["tiny", "7b", "13b"])
    ap.add_argument("--quant", default=None,
                    choices=["int8", "int4", "auto"],
                    help="weights-only LLM quantization at load, resolved "
                    "against the checkpoint's quant_preflight.json as in "
                    "the JAX package")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--served_name", default="vicuna-13b-v1.5")
    ap.add_argument("--conv_mode", default="vicuna_v1_1")
    ap.add_argument("--mesh_model", type=int, default=None,
                    help="tensor-parallel degree (ranks; default 1)")
    ap.add_argument("--dist_backend", default="nccl",
                    choices=["nccl", "gloo"],
                    help="collectives under --mesh_model: nccl (a card a "
                    "rank) or gloo (ranks may share a card; the CPU)")
    ap.add_argument("--dist_init", default=None,
                    help="rendezvous of the ranks: tcp://localhost:PORT or "
                    "file://PATH (default: a free localhost port)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model (default cuda)")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"],
                    help="parameter and KV-cache dtype (float32: CPU "
                    "checks)")
    # batching modes (default: serialized)
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching (persistent slot decode)")
    ap.add_argument("--num_slots", type=int, default=4)
    ap.add_argument("--max_cache_len", type=int, default=2048)
    ap.add_argument("--paged", action="store_true",
                    help="paged KV pool for --continuous (shared block "
                    "pool + per-slot block tables)")
    ap.add_argument("--num_blocks", type=int, default=None,
                    help="paged pool size in 64-token blocks (default: "
                    "slot-cache capacity)")
    ap.add_argument("--prefix_cache", action="store_true",
                    help="automatic prefix caching (implies --paged)")
    ap.add_argument("--batching", action="store_true",
                    help="windowed request batching")
    ap.add_argument("--max_batch", type=int, default=8)
    ap.add_argument("--window_ms", type=float, default=30.0)
    ap.add_argument("--no_speculative", action="store_true")
    args = ap.parse_args(argv)
    quant = resolve_quant(args.quant, args.model_name)
    session = driver.start(
        args.mesh_model, args.dist_backend, args.dist_init, args.device,
        entry=("video_llava_tpu_torch.serving.__main__", "main"),
        argv=sys.argv[1:] if argv is None else list(argv))
    try:
        if args.quant == "auto" and not session.follower:
            print(f"--quant auto -> {quant or 'bf16'} (preflight record)",
                  flush=True)
        # one card: the fused wqkv/gate_up layout, as the JAX CLI builds
        # it; a mesh shards the unfused names
        engine = initialize_model(
            model_name=args.model_name, model_size=args.model_size,
            device=session.device, llm_quant=quant,
            llm_fuse=bool(quant) and session.world_size == 1,
            mesh_model=args.mesh_model, **dtype_kwargs(args.dtype))
        if session.follower:
            driver.follow()
            return
        model = driver.new(
            ChatModel, model=engine.model, cfg=engine.cfg,
            tokenizer=engine.tokenizer, conv_mode=args.conv_mode,
            cache_dtype=(torch.int8 if quant == "int8"
                         else getattr(torch, args.dtype)),
            speculative=not args.no_speculative)
        serve(model, host=args.host, port=args.port,
              model_name=args.served_name, batching=args.batching,
              max_batch=args.max_batch, window_ms=args.window_ms,
              continuous=args.continuous,
              num_slots=args.num_slots, max_cache_len=args.max_cache_len,
              paged=args.paged, num_blocks=args.num_blocks,
              prefix_cache=args.prefix_cache)
    finally:
        driver.stop()


if __name__ == "__main__":
    main()
