"""Quantization quality validation: bf16 vs int8/int4 LLM weights, and
the CLIP tower's W8A8 form vs bf16.

Counterpart of video_llava_tpu/scripts/validate_quant_quality.py, with
its flags, metrics, gates and record keys. Metrics per format,
teacher-forced over sliding windows of text:
  * perplexity (f32 log-softmax over the full vocab);
  * top-1 agreement vs the bf16 logits (a greedy-decode proxy);
  * mean KL(bf16 || quant) per scored token.
The vision gate (--vision) holds the per-token cosine of the W8A8
tower's penultimate features against bf16 (mean and 5th percentile).
--preflight --record writes the decision as quant_preflight.json, which
engine/quant_select.py reads (--quant auto / int4, clip_dtype auto /
int8).

    python -m video_llava_tpu_torch.scripts.validate_quant_quality \\
        --weights VICUNA_DIR --tokenizer VICUNA_DIR --text wiki.txt \\
        --formats bf16,int8,int4 [--vision] [--preflight --record]

The checkpoint is read by engine/weights.py and the text tokenized by
runtime/tokenizer.LlamaTokenizer (no tokenizer or safetensors library).
Quantized models are built from the bf16 one by the port's loader
(weights.convert_llama into a quantized Llama), as a checkpoint load at
--quant does. --video decodes through media/loader (libav); without it
the vision gate reads seeded frames. Runs on the card unless --device
says otherwise.

Offline self-test (a random tiny model and tower: every code path runs,
the deltas mean nothing):

    python -m video_llava_tpu_torch.scripts.validate_quant_quality \\
        --self_test [--device cpu]
"""

from __future__ import annotations

import argparse
import copy
import json
import sys

import numpy as np
import torch

from video_llava_tpu_torch.config import CLIPVisionConfig, LlamaConfig
from video_llava_tpu_torch.engine import weights as weights_mod
from video_llava_tpu_torch.engine.quant_select import record_path
from video_llava_tpu_torch.engine.weights import LLAMA_LINEARS, LLAMA_NORMS
from video_llava_tpu_torch.models.clip import CLIPVisionTower, quantize_a8_
from video_llava_tpu_torch.models.llama import Llama
from video_llava_tpu_torch.ops.image import normalize_clip
from video_llava_tpu_torch.runtime.model_init import random_init_


def hf_state(llm: Llama) -> dict:
    """A dense Llama's weights under the HF names weights.convert_llama
    reads (kernels transposed back to (out, in): views, no copies)."""
    sd = {"model.embed_tokens.weight": llm.embed_tokens.weight,
          "model.norm.weight": llm.final_norm.scale,
          "lm_head.weight": llm.lm_head.kernel.t()}
    for li, layer in enumerate(llm.layers):
        pre = f"model.layers.{li}."
        for hf, ours in LLAMA_LINEARS.items():
            sd[pre + hf] = getattr(layer, ours).kernel.t()
        for hf, ours in LLAMA_NORMS.items():
            sd[pre + hf] = layer.get_parameter(ours)
    return sd


@torch.no_grad()
def _quantize(llm: Llama, fmt: str) -> Llama:
    """The bf16 model in `fmt`: quantized by the port's loader with the
    JAX package's layout rules (quantize_params / quantize_params_int4
    over the stacked tree, min_size 1 << 16, int4 groups of 128)."""
    if fmt == "bf16":
        return llm
    if fmt not in ("int8", "int4"):
        raise SystemExit(f"unknown format {fmt!r} (use bf16,int8,int4)")
    scale = llm.final_norm.scale
    q = Llama(llm.cfg, device=scale.device, dtype=scale.dtype, quant=fmt)
    weights_mod.convert_llama(hf_state(llm), q)
    return q


@torch.no_grad()
def evaluate(llm: Llama, token_ids: np.ndarray, seq: int, stride: int,
             ref_logp=None):
    """Sliding-window teacher-forced scoring -> (metrics, the windows'
    f32 log-probs of their last min(stride, seq - 1) targets, on the
    model's device: the bf16 pass's are the reference of the others)."""
    dev = llm.final_norm.scale.device
    n_score = min(stride, seq - 1)
    nlls, agree, kls, logps = [], [], [], []
    n_tok = len(token_ids)
    if n_tok < seq:
        raise ValueError(
            f"eval text tokenizes to {n_tok} tokens, shorter than one "
            f"--seq {seq} window — use more text or a smaller --seq")
    starts = list(range(0, max(1, n_tok - seq + 1), stride))
    for wi, s0 in enumerate(starts):
        win = token_ids[s0:s0 + seq]
        if len(win) < seq:
            break
        ids = torch.as_tensor(np.asarray(win, np.int64), device=dev)
        logits, _ = llm(None, input_ids=ids[None])
        logits = logits[0, :-1]  # predicts ids[1:]
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -logp.gather(-1, ids[1:, None])[:, 0]
        top1, logp = logits.argmax(-1)[-n_score:], logp[-n_score:]
        nlls.append(nll[-n_score:].cpu().numpy())
        logps.append(logp)
        if ref_logp is not None:
            ref = ref_logp[wi]
            agree.append((top1 == ref.argmax(-1)).cpu().numpy())
            kls.append((ref.exp() * (ref - logp)).sum(-1).cpu().numpy())
    nll_all = np.concatenate(nlls)
    out = {"perplexity": float(np.exp(nll_all.mean())),
           "mean_nll": float(nll_all.mean()),
           "tokens_scored": int(nll_all.size)}
    if ref_logp is not None:
        out["top1_agreement_vs_bf16"] = float(np.concatenate(agree).mean())
        out["mean_kl_vs_bf16"] = float(np.concatenate(kls).mean())
    return out, logps


def _load_real(args, device):
    from video_llava_tpu_torch.runtime.tokenizer import LlamaTokenizer

    cfg = (LlamaConfig.vicuna_7b() if args.model_size == "7b"
           else LlamaConfig.vicuna_13b())
    llm = Llama(cfg, device=device, dtype=torch.bfloat16)
    weights_mod.convert_llama(weights_mod.checkpoint_shards(args.weights),
                              llm)
    tok = LlamaTokenizer(args.tokenizer)
    with open(args.text) as f:
        ids = np.asarray(tok.encode(f.read()), np.int32)
    return llm, ids


SELF_TEST_LLM = LlamaConfig(vocab_size=1024, hidden_size=256,
                            intermediate_size=512, num_layers=4, num_heads=4,
                            num_kv_heads=4, head_dim=64)
SELF_TEST_VISION = CLIPVisionConfig(image_size=32, patch_size=16,
                                    hidden_size=64, intermediate_size=128,
                                    num_layers=3, num_heads=4)


def _random(module: torch.nn.Module, seed: int, device):
    random_init_(module, torch.Generator(device=device).manual_seed(seed))
    return module.requires_grad_(False)


def _load_self_test(device):
    """A random tiny bf16 LLM (the JAX self-test's shape) and 4,096
    seeded token ids."""
    llm = _random(Llama(SELF_TEST_LLM, device=device, dtype=torch.bfloat16),
                  0, device)
    ids = np.asarray(np.random.default_rng(0).integers(0, 1024, size=4096),
                     np.int32)
    return llm, ids


def _self_test_tower(device) -> CLIPVisionTower:
    return _random(CLIPVisionTower(SELF_TEST_VISION, device=device,
                                   dtype=torch.bfloat16), 1, device)


@torch.no_grad()
def evaluate_vision(tower: CLIPVisionTower, pixels: torch.Tensor,
                    min_cos: float):
    """CLIP W8A8 gate: per-patch-token cosine of the penultimate features
    (what the feature extractor keeps), W8A8 vs the bf16 tower. Both the
    mean and the 5th percentile must clear the threshold (p5 by
    min_cos - 0.005). Returns (metrics, 'int8' or 'bf16')."""
    ref = tower.penultimate_patches(pixels).float().cpu().numpy()
    # min_size 1 << 10, so the self-test's tiny tower quantizes too
    # (every ViT-L/14 kernel is past 1M elements either way)
    q = quantize_a8_(copy.deepcopy(tower), min_size=1 << 10)
    got = q.penultimate_patches(pixels).float().cpu().numpy()
    del q
    r = ref.reshape(-1, ref.shape[-1])
    g = got.reshape(-1, got.shape[-1])
    cos = np.sum(r * g, -1) / np.maximum(
        np.linalg.norm(r, axis=-1) * np.linalg.norm(g, axis=-1), 1e-8)
    metrics = {
        "feature_cos_mean": float(cos.mean()),
        "feature_cos_p5": float(np.percentile(cos, 5)),
        "rel_l2": float(np.linalg.norm(g - r)
                        / max(np.linalg.norm(r), 1e-8)),
        "tokens": int(cos.size),
    }
    ok = (metrics["feature_cos_mean"] >= min_cos
          and metrics["feature_cos_p5"] >= min_cos - 0.005)
    return metrics, ("int8" if ok else "bf16")


def choose_format(results: dict, max_ppl_delta_pct: float = 1.0,
                  min_top1: float = 0.97) -> str:
    """The int4 -> int8 -> bf16 fallback: the narrowest format whose
    perplexity regression and top-1 agreement stay within bounds."""
    base = results["bf16"]["perplexity"]
    for fmt in ("int4", "int8"):
        m = results.get(fmt)
        if m is None:
            continue
        ppl_delta = 100.0 * (m["perplexity"] - base) / base
        if (ppl_delta <= max_ppl_delta_pct
                and m.get("top1_agreement_vs_bf16", 0.0) >= min_top1):
            return fmt
    return "bf16"


def _vision_frames(args, image_size: int) -> np.ndarray:
    if args.video:
        from video_llava_tpu_torch.media.loader import load_video

        return load_video(args.video, num_frm=args.vision_frames,
                          shape=(image_size, image_size))
    return np.random.default_rng(0).integers(
        0, 256, size=(args.vision_frames, image_size, image_size, 3),
    ).astype(np.uint8)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="video_llava_tpu_torch.scripts.validate_quant_quality")
    ap.add_argument("--weights", help="HF checkpoint dir (bin/safetensors)")
    ap.add_argument("--tokenizer", help="tokenizer dir (tokenizer.json or "
                    "tokenizer.model)")
    ap.add_argument("--text", help="plain-text eval file")
    ap.add_argument("--model_size", default="7b", choices=["7b", "13b"])
    ap.add_argument("--formats", default="bf16,int8,int4")
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--stride", type=int, default=512)
    ap.add_argument("--self_test", action="store_true")
    ap.add_argument("--preflight", action="store_true",
                    help="print the serving format decision (int4 if "
                    "within thresholds, else int8, else bf16) as the last "
                    "JSON line")
    ap.add_argument("--record", nargs="?", const="", default=None,
                    help="with --preflight: write the decision as a "
                    "quant_preflight.json record, next to --weights when "
                    "bare, else at the path given")
    ap.add_argument("--max_ppl_delta_pct", type=float, default=1.0)
    ap.add_argument("--min_top1", type=float, default=0.97)
    ap.add_argument("--vision", action="store_true",
                    help="also gate the CLIP tower: W8A8 vs bf16 per-token "
                    "feature cosine; adds preflight_vision_format to the "
                    "record (clip_dtype auto reads it)")
    ap.add_argument("--clip_weights",
                    help="CLIP vision checkpoint dir; omitted -> random "
                    "init (the gate is then indicative only)")
    ap.add_argument("--video", help="video file for the vision gate's "
                    "frames (omitted -> seeded frames)")
    ap.add_argument("--vision_frames", type=int, default=16)
    ap.add_argument("--min_vision_cos", type=float, default=0.99)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    if args.self_test:
        llm_bf16, ids = _load_self_test(device)
        args.seq, args.stride = 256, 128
    else:
        if not (args.weights and args.tokenizer and args.text):
            ap.error("--weights/--tokenizer/--text required (or --self_test)")
        llm_bf16, ids = _load_real(args, device)

    formats = [f.strip() for f in args.formats.split(",")]
    if "bf16" not in formats:
        formats = ["bf16"] + formats  # the reference pass is mandatory

    results = {}
    ref_logps = None
    for fmt in formats:
        llm = _quantize(llm_bf16, fmt)
        metrics, logps = evaluate(
            llm, ids, args.seq, args.stride,
            ref_logp=None if fmt == "bf16" else ref_logps)
        if fmt == "bf16":
            ref_logps = logps
        del llm, logps
        results[fmt] = metrics
        print(json.dumps({"format": fmt, **metrics}), flush=True)
    del ref_logps, llm_bf16

    base = results["bf16"]["perplexity"]
    for fmt, m in results.items():
        if fmt != "bf16":
            print(json.dumps({"format": fmt, "ppl_delta_pct":
                              100.0 * (m["perplexity"] - base) / base}),
                  flush=True)

    vision_metrics = vision_fmt = None
    if args.vision or args.self_test:
        if args.self_test:
            vcfg, tower = SELF_TEST_VISION, _self_test_tower(device)
        else:
            vcfg = CLIPVisionConfig()
            tower = CLIPVisionTower(vcfg, device=device,
                                    dtype=torch.bfloat16)
            if args.clip_weights:
                weights_mod.convert_clip_vision(
                    weights_mod.checkpoint_shards(args.clip_weights), tower)
                tower.requires_grad_(False)
            else:
                print("# vision gate on RANDOM weights (no --clip_weights)"
                      " — indicative only", flush=True)
                _random(tower, 1, device)
        frames = _vision_frames(args, vcfg.image_size)
        pixels = normalize_clip(torch.from_numpy(frames).to(device),
                                dtype=torch.bfloat16)
        vision_metrics, vision_fmt = evaluate_vision(tower, pixels,
                                                     args.min_vision_cos)
        del tower
        print(json.dumps({"vision_format": vision_fmt, **vision_metrics}),
              flush=True)

    if args.preflight:
        record = {
            "preflight_llm_format": choose_format(
                results, args.max_ppl_delta_pct, args.min_top1),
            "max_ppl_delta_pct": args.max_ppl_delta_pct,
            "min_top1": args.min_top1,
            "metrics": results,
        }
        if vision_fmt is not None:
            record["preflight_vision_format"] = vision_fmt
            record["min_vision_cos"] = args.min_vision_cos
            record["vision_metrics"] = vision_metrics
            record["vision_weights_real"] = bool(args.clip_weights)
        print(json.dumps(record), flush=True)
        if args.record is not None:
            path = args.record or (record_path(args.weights)
                                   if args.weights else None)
            if not path:
                ap.error("--record without a path needs --weights")
            with open(path, "w") as f:
                json.dump(record, f, indent=1)
            print(f"# preflight record written to {path}", flush=True)

    if args.self_test:
        d8 = abs(results["int8"]["perplexity"] - base) / base
        assert d8 < 0.25, f"int8 self-test ppl delta {d8:.3f} implausible"
        assert results["int8"]["top1_agreement_vs_bf16"] > 0.5
        assert choose_format(results) in ("bf16", "int8", "int4")
        assert vision_metrics is not None
        # close to bf16 but not equal (0 would mean nothing quantized)
        assert 0.5 < vision_metrics["feature_cos_mean"] < 1.0
        assert vision_metrics["rel_l2"] > 0.0
        print("self_test OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
