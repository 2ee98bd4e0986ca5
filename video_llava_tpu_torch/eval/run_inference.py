"""Zero-shot QA and generative-benchmark inference runners.

Counterpart of video_llava_tpu/eval/run_inference.py: the reference's
per-dataset drivers, all of which delegate to video_chatgpt_infer with
per-sample try/except-and-continue:
  * ActivityNet-QA (run_inference_qa_activitynet.py:29-108): separate
    question/answer JSONs, "v_{name}" video files;
  * MSVD-QA (run_inference_qa_msvd.py), MSRVTT-QA with its video-name
    mapping JSON (run_inference_qa_msrvtt.py);
  * TGIF-QA with GIF loading at 8 frames (run_inference_qa_tgif.py:30-54);
  * generic benchmark single-question (run_inference_benchmark_general
    .py:28-97) and two-question consistency
    (run_inference_benchmark_consistency.py:28-97).
Beside the sequential loop, a batched runner (B videos encoded, prefilled
and decoded together: CLIP once over all B*T frames, the pooling kernel
over every video in one launch, one generate call) and a continuous one
over the slot engine (engine/continuous.py).

Run: python -m video_llava_tpu_torch.eval.run_inference --dataset
activitynet ... (random weights unless --model_name, --clip_path and
--projection_path give checkpoints; on `cuda` unless --device says
otherwise). --mesh_model m runs any runner tensor parallel over m ranks
(parallel/): rank 0 loads the videos, keeps the queue and writes the
answers; the others follow its engine calls (parallel/driver.py),
spawned by rank 0 unless torchrun started them (--dist_backend,
--dist_init as in the serving CLI). A mesh turns the fused layout off,
as in the JAX runner.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from video_llava_tpu_torch.engine.continuous import (
    ContinuousEngine,
    SlotRequest,
)
from video_llava_tpu_torch.media.loader import load_video
from video_llava_tpu_torch.parallel import driver
from video_llava_tpu_torch.runtime.conversation import conv_templates
from video_llava_tpu_torch.runtime.inference import (
    InferenceEngine,
    build_video_question,
)
from video_llava_tpu_torch.runtime.model_init import (
    dtype_kwargs,
    initialize_model,
)

VIDEO_FORMATS = [".mp4", ".avi", ".mov", ".mkv", ".webm", ".gif"]

def find_video(video_dir: str, video_name: str, prefix: str = "") -> Optional[str]:
    for fmt in VIDEO_FORMATS:
        path = os.path.join(video_dir, f"{prefix}{video_name}{fmt}")
        if os.path.exists(path):
            return path
    return None


def _maybe_transcribe(transcriber, video_path: str) -> Optional[str]:
    if transcriber is None:
        return None
    try:
        text, _ = transcriber.transcribe_video(video_path)
        return text
    except Exception:
        return None


def run_qa(
    engine: InferenceEngine,
    samples: List[Dict],
    video_dir: str,
    conv_mode: str,
    video_prefix: str = "",
    num_frames: int = 100,
    transcriber=None,
    on_result: Optional[Callable[[Dict], None]] = None,
) -> List[Dict]:
    """Single-question loop (per-sample fault tolerance preserved)."""
    out: List[Dict] = []
    for sample in samples:
        try:
            video_path = find_video(video_dir, sample["video_name"], video_prefix)
            if video_path is None:
                raise FileNotFoundError(sample["video_name"])
            frames = load_video(
                video_path,
                num_frm=num_frames,
                shape=(engine.cfg.vision.image_size, engine.cfg.vision.image_size),
            )
            transcript = _maybe_transcribe(transcriber, video_path)
            pred = engine.infer(
                frames, sample["question"], conv_mode, transcript,
                num_valid_frames=frames.shape[0],
            )
            result = dict(sample)
            result["pred"] = pred
            out.append(result)
            if on_result:
                on_result(result)
        except Exception as e:  # noqa: BLE001 (reference behavior)
            print(f"Error processing video file '{sample.get('video_name')}': {e}")
    return out


def _load_chunk(chunk: List[Dict], video_dir: str, video_prefix: str,
                num_frames: int, size: int):
    """Load each sample's video, zero-padded to num_frames -> (loaded
    samples, their frames (B, num_frames, size, size, 3), valid counts);
    a sample whose video fails to load is printed and skipped."""
    loaded, frames_list, nvalid = [], [], []
    for sample in chunk:
        try:
            path = find_video(video_dir, sample["video_name"], video_prefix)
            if path is None:
                raise FileNotFoundError(sample["video_name"])
            f = load_video(path, num_frm=num_frames, shape=(size, size))
            t = f.shape[0]
            if t < num_frames:
                f = np.pad(f, ((0, num_frames - t), (0, 0), (0, 0), (0, 0)))
            frames_list.append(f)
            nvalid.append(t)
            loaded.append(sample)
        except Exception as e:  # noqa: BLE001
            print(f"Error loading '{sample.get('video_name')}': {e}")
    frames = np.stack(frames_list) if loaded else None
    return loaded, frames, nvalid


def _prompt_ids(engine: InferenceEngine, question: str,
                conv_mode: str) -> List[int]:
    cfg = engine.cfg
    qs = build_video_question(question, cfg.video_token_len,
                              cfg.use_vid_start_end)
    conv = conv_templates[conv_mode].copy()
    conv.append_message(conv.roles[0], qs)
    conv.append_message(conv.roles[1], None)
    return engine.tokenizer.encode(conv.get_prompt())


def run_qa_batched(
    engine: InferenceEngine,
    samples: List[Dict],
    video_dir: str,
    conv_mode: str,
    batch_size: int = 8,
    video_prefix: str = "",
    num_frames: int = 100,
    max_new_tokens: int = 128,
) -> List[Dict]:
    """Batched QA: B videos encode, prefill and decode together (the
    reference runs strictly one video at a time). Samples whose video
    fails to load are skipped (per-sample fault tolerance preserved).
    The generator of the chunk starting at sample `start` is seeded with
    `start`, where the JAX package draws from PRNGKey(start)."""
    cfg, tok = engine.cfg, engine.tokenizer
    size = cfg.vision.image_size
    dev = engine.device
    out: List[Dict] = []

    for start in range(0, len(samples), batch_size):
        chunk = samples[start : start + batch_size]
        loaded, frames, nvalid = _load_chunk(chunk, video_dir, video_prefix,
                                             num_frames, size)
        if not loaded:
            continue
        with torch.inference_mode():
            feats = engine.batched_encode(frames, nvalid)

            # tokenize prompts, right-pad to one bucket
            ids_list = [_prompt_ids(engine, s["question"], conv_mode)
                        for s in loaded]
            lens = [len(i) for i in ids_list]
            bucket = (-(-max(lens) // engine.seq_pad_multiple)
                      * engine.seq_pad_multiple)
            input_ids = np.full((len(loaded), bucket), tok.pad_token_id,
                                np.int64)
            for r, ids in enumerate(ids_list):
                input_ids[r, : len(ids)] = ids

            gen = dataclasses.replace(
                engine.gen,
                max_new_tokens=max_new_tokens,
                eos_token_id=tok.eos_token_id,
                pad_token_id=tok.pad_token_id,
            )
            res = engine.generate_tokens(
                torch.from_numpy(input_ids).to(dev),
                torch.tensor(lens, dtype=torch.int32, device=dev), feats,
                gen, seed=start)
            toks = res.tokens.cpu().numpy()
            lengths = res.lengths.cpu().numpy()
        for r, sample in enumerate(loaded):
            text = tok.decode(
                [int(t) for t in toks[r, : lengths[r]]], skip_special_tokens=True
            )
            result = dict(sample)
            result["pred"] = text.strip()
            out.append(result)
    return out


def run_qa_continuous(
    engine: InferenceEngine,
    samples: List[Dict],
    video_dir: str,
    conv_mode: str,
    batch_size: int = 8,
    num_slots: int = 8,
    max_cache_len: int = 1024,
    video_prefix: str = "",
    num_frames: int = 100,
    max_new_tokens: int = 128,
) -> List[Dict]:
    """Continuous-batching QA sweep: videos load and encode in
    mini-batches on this thread while the engine thread decodes the
    requests already admitted, and short answers retire their slot
    early instead of padding to the batch's longest (run_qa_batched
    decodes every row to the slowest one's length). Greedy outputs are
    the batched runner's. Requests the engine fails are printed and
    skipped; the engine thread stops on the way out, also when a load,
    an encode or a submit raises."""
    cfg, tok = engine.cfg, engine.tokenizer
    size = cfg.vision.image_size
    ceng = driver.new(
        ContinuousEngine,
        engine.model,
        cfg,
        num_slots=num_slots,
        max_cache_len=max_cache_len,
        cache_dtype=engine.cache_dtype,
        prompt_pad=engine.seq_pad_multiple,
        speculative=engine.speculative,
    )
    ceng.start()
    pending: List[tuple] = []  # (sample, handle)
    try:
        for start in range(0, len(samples), batch_size):
            chunk = samples[start : start + batch_size]
            loaded, frames, nvalid = _load_chunk(
                chunk, video_dir, video_prefix, num_frames, size)
            if not loaded:
                continue
            feats = engine.batched_encode(frames, nvalid)
            for r, sample in enumerate(loaded):
                handle = ceng.submit(SlotRequest(
                    _prompt_ids(engine, sample["question"], conv_mode),
                    max_new_tokens=max_new_tokens,
                    eos_token_id=tok.eos_token_id,
                    video_features=feats[r],
                ))
                pending.append((sample, handle))
        out: List[Dict] = []
        for sample, handle in pending:
            try:
                toks = handle.result()
            except RuntimeError as e:  # engine-failed request
                print(f"Error generating '{sample.get('video_name')}': {e}")
                continue
            result = dict(sample)
            result["pred"] = tok.decode(
                toks, skip_special_tokens=True
            ).strip()
            out.append(result)
        return out
    finally:
        ceng.stop()


def run_consistency(
    engine: InferenceEngine,
    samples: List[Dict],
    video_dir: str,
    conv_mode: str,
    num_frames: int = 100,
    transcriber=None,
) -> List[Dict]:
    """Two-question consistency loop
    (run_inference_benchmark_consistency.py:28-97)."""
    out: List[Dict] = []
    for sample in samples:
        try:
            video_path = find_video(video_dir, sample["video_name"])
            if video_path is None:
                raise FileNotFoundError(sample["video_name"])
            frames = load_video(
                video_path,
                num_frm=num_frames,
                shape=(engine.cfg.vision.image_size, engine.cfg.vision.image_size),
            )
            transcript = _maybe_transcribe(transcriber, video_path)
            result = dict(sample)
            result["pred1"] = engine.infer(
                frames, sample["Q1"], conv_mode, transcript,
                num_valid_frames=frames.shape[0],
            )
            result["pred2"] = engine.infer(
                frames, sample["Q2"], conv_mode, transcript,
                num_valid_frames=frames.shape[0],
            )
            out.append(result)
        except Exception as e:  # noqa: BLE001
            print(f"Error processing video file '{sample.get('video_name')}': {e}")
    return out


def load_dataset(args) -> List[Dict]:
    """Normalize the per-dataset JSON layouts to a flat sample list."""
    if args.dataset == "activitynet":
        with open(args.gt_file_question) as f:
            questions = json.load(f)
        with open(args.gt_file_answers) as f:
            answers = json.load(f)
        samples = []
        for q, a in zip(questions, answers):
            samples.append(
                {
                    "id": q["question_id"],
                    "video_name": q["video_name"],
                    "question": q["question"],
                    "answer": a["answer"],
                }
            )
        return samples
    with open(args.gt_file) as f:
        data = json.load(f)
    if args.dataset == "msrvtt" and args.video_name_mapping:
        with open(args.video_name_mapping) as f:
            mapping = json.load(f)
        for s in data:
            s["video_name"] = mapping.get(s["video_name"], s["video_name"])
    return data


def main(argv=None) -> List[Dict]:
    p = argparse.ArgumentParser()
    p.add_argument(
        "--dataset",
        required=True,
        choices=["activitynet", "msvd", "msrvtt", "tgif", "benchmark",
                 "consistency"],
    )
    p.add_argument("--model_name", default=None,
                   help="HF Vicuna/LLaMA checkpoint directory")
    p.add_argument("--projection_path", default=None,
                   help="reference-style mm_projector.bin")
    p.add_argument("--clip_path", default=None,
                   help="HF CLIP checkpoint directory")
    p.add_argument("--model_size", default="7b")
    p.add_argument("--video_dir", required=True)
    p.add_argument("--gt_file", default=None)
    p.add_argument("--gt_file_question", default=None)
    p.add_argument("--gt_file_answers", default=None)
    p.add_argument("--video_name_mapping", default=None)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--output_name", required=True)
    p.add_argument("--conv_mode", default="pg-video-llava")
    p.add_argument("--use_asr", action="store_true")
    p.add_argument("--mesh_model", type=int, default=None,
                   help="tensor-parallel degree (ranks; default 1)")
    p.add_argument("--dist_backend", default="nccl",
                   choices=["nccl", "gloo"],
                   help="collectives under --mesh_model: nccl (a card a "
                   "rank) or gloo (ranks may share a card; the CPU)")
    p.add_argument("--dist_init", default=None,
                   help="rendezvous of the ranks: tcp://localhost:PORT or "
                   "file://PATH (default: a free localhost port)")
    p.add_argument("--runner", default="sequential",
                   choices=["sequential", "batched", "continuous"],
                   help="batched: B videos per generate call; "
                   "continuous: slot engine, short answers retire "
                   "early while the next videos load/encode")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--num_slots", type=int, default=8)
    p.add_argument("--quant", default=None,
                   choices=["int8", "int4", "auto"],
                   help="weights-only LLM quantization; preflight-"
                   "gated against real checkpoints like serving")
    p.add_argument("--device", default="cuda",
                   help="torch device of the model (default cuda)")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"],
                   help="parameter and KV-cache dtype (float32: CPU "
                   "checks)")
    args = p.parse_args(argv)

    from video_llava_tpu_torch.engine.quant_select import resolve_quant

    quant = resolve_quant(args.quant, args.model_name)
    session = driver.start(
        args.mesh_model, args.dist_backend, args.dist_init, args.device,
        entry=("video_llava_tpu_torch.eval.run_inference", "main"),
        argv=sys.argv[1:] if argv is None else list(argv))
    try:
        engine = initialize_model(
            args.model_name,
            args.projection_path,
            args.clip_path,
            model_size=args.model_size,
            device=session.device,
            llm_quant=quant,
            # the fused layout, as the JAX package sets it on one device
            llm_fuse=bool(quant) and session.world_size == 1,
            mesh_model=args.mesh_model,
            **dtype_kwargs(args.dtype),
        )
        if args.dtype == "float32":
            engine.cache_dtype = torch.float32
        if session.follower:
            driver.follow()
            return []
        return _run(args, engine)
    finally:
        driver.stop()


def _run(args, engine: InferenceEngine) -> List[Dict]:
    """main's work on rank 0: the dataset through the chosen runner,
    the answers file."""
    transcriber = None
    if args.use_asr:
        from video_llava_tpu_torch.audio.builders import (
            build_default_transcriber,
        )

        transcriber = build_default_transcriber(device=args.device)

    samples = load_dataset(args)
    os.makedirs(args.output_dir, exist_ok=True)
    # TGIF loads GIFs at 8 frames (run_inference_qa_tgif.py:30-54).
    num_frames = 8 if args.dataset == "tgif" else 100
    prefix = "v_" if args.dataset == "activitynet" else ""

    if args.dataset == "consistency":
        results = run_consistency(
            engine, samples, args.video_dir, args.conv_mode,
            transcriber=transcriber,
        )
    elif args.runner == "batched":
        results = run_qa_batched(
            engine, samples, args.video_dir, args.conv_mode,
            batch_size=args.batch_size, video_prefix=prefix,
            num_frames=num_frames,
        )
    elif args.runner == "continuous":
        results = run_qa_continuous(
            engine, samples, args.video_dir, args.conv_mode,
            batch_size=args.batch_size, num_slots=args.num_slots,
            video_prefix=prefix, num_frames=num_frames,
        )
    else:
        results = run_qa(
            engine, samples, args.video_dir, args.conv_mode,
            video_prefix=prefix, num_frames=num_frames,
            transcriber=transcriber,
        )

    with open(os.path.join(args.output_dir, f"{args.output_name}.json"), "w") as f:
        json.dump(results, f)
    print(f"wrote {len(results)} results")
    return results


if __name__ == "__main__":
    main()
