"""Batched video QA: the batched eval runner's loop, closed.

Each step is one call of eval/run_inference.run_qa_batched's body on a
batch of videos: ``InferenceEngine.batched_encode`` over the batch's
frames, the prompts right-padded to one multiple of the engine's
``seq_pad_multiple`` (128, the runner's), then
``InferenceEngine.generate_tokens`` (greedy, end-of-sequence disabled,
speculation off, so every answer has the batch's drawn length), whose
tokens come back to the host before the next step. A step's record
holds its shapes (``batch``, ``frames`` a video, ``prompt_lens``, the
padded ``s_pad``, ``answer_len``), which the metric readers count
operations and bytes from.

The mix's parameters (``portbench/traffic/<mix>.json``): ``batch``
videos a step from a pool of ``clips`` uint8 clips of ``frames`` frames
of ``frame_size`` pixels drawn from the seed; prompts of the
conversation template (``template_tokens``: before and after the
turn), a question of ``question_tokens`` [lo, hi], the <vid_start>, the
video tokens and <vid_end>, then a transcript of ``transcript_tokens``
[lo, hi]; answers of ``answer_tokens`` [lo, hi]; ``llm_weights``
("int4" or "bf16"); ``check``: the requests sampled for the reference
and the limit of the widest gap.

Every seed draws the same sizes in another order: each batch's rows
take ``batch`` lengths spread evenly over their range, shuffled; the
answer lengths come in pairs (L, lo + hi - L), so that any two
consecutive steps decode as many tokens as any other two, and each block
of 2 (hi - lo + 1) steps holds every pair once, so that every length
appears twice a block. Token ids and pixels are the seed's own.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import weights
from portbench.reference import model as ref


def seeded(seed: int, *key) -> np.random.Generator:
    """A numpy generator for (seed, key...)."""
    text = "/".join(str(k) for k in (int(seed),) + key)
    digest = hashlib.sha256(text.encode()).digest()
    return np.random.default_rng(int.from_bytes(digest[:16], "little"))


def spread(rng: np.random.Generator, lo: int, hi: int,
           n: int) -> np.ndarray:
    """n lengths spread evenly over [lo, hi] (both ends included), in a
    seeded order."""
    if n == 1 or hi <= lo:
        return np.full(n, hi, dtype=np.int64)
    at = np.rint(lo + (hi - lo) * np.arange(n) / (n - 1)).astype(np.int64)
    return rng.permutation(at)


def answer_length(seed: int, k: int, lo: int, hi: int) -> int:
    """Step k's answer length. Block j of 2n steps (n = hi - lo + 1)
    takes the n pairs (L, lo + hi - L), L in [lo, hi], in a seeded
    order, each pair's two members in a seeded order."""
    n = hi - lo + 1
    block, at = divmod(k, 2 * n)
    rng = seeded(seed, "answer", block)
    pairs = rng.permutation(n)
    flips = rng.integers(0, 2, n)
    pair = at // 2
    length = lo + int(pairs[pair])
    return length if (at % 2) == flips[pair] else lo + hi - length


def clip_ids(seed: int, k: int, batch: int, pool: int) -> np.ndarray:
    """Step k's clips: the pool in a seeded order, cycled."""
    out = []
    for i in range(k * batch, (k + 1) * batch):
        out.append(seeded(seed, "clips", i // pool).permutation(pool)[
            i % pool])
    return np.asarray(out, dtype=np.int64)


@dataclasses.dataclass
class Batch:
    clips: np.ndarray  # (b,) pool indices
    prompts: List[np.ndarray]  # each row's prompt ids
    answer: int  # tokens every row answers


class Plan:
    """The seed's traffic: the template's ids and each step's batch."""

    def __init__(self, cfg: dict, mix: dict, seed: int):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        special = {cfg["bos_token_id"], cfg["eos_token_id"],
                   cfg["pad_token_id"]}
        self.allowed = np.setdiff1d(np.arange(cfg["vocab_size"]),
                                    np.asarray(sorted(special)))
        rng = seeded(seed, "template")
        before, after = mix["template_tokens"]
        self.before = self.draw(rng, before)
        self.after = self.draw(rng, after)
        v = cfg["vision_config"]
        self.video = np.concatenate([
            [cfg["vid_start_token_id"]],
            np.full((v["image_size"] // v["patch_size"]) ** 2
                    + cfg["max_temporal_tokens"], cfg["vid_patch_token_id"]),
            [cfg["vid_end_token_id"]]]).astype(np.int64)

    def draw(self, rng: np.random.Generator, n: int) -> np.ndarray:
        return self.allowed[rng.integers(0, len(self.allowed), n)]

    def prompt(self, rng, question: int, transcript: int) -> np.ndarray:
        return np.concatenate([[self.cfg["bos_token_id"]], self.before,
                               self.draw(rng, question), self.video,
                               self.draw(rng, transcript),
                               self.after]).astype(np.int64)

    def batch(self, k: int) -> Batch:
        mix, b = self.mix, self.mix["batch"]
        rng = seeded(self.seed, "batch", k)
        qs = spread(rng, *mix["question_tokens"], b)
        ts = spread(rng, *mix["transcript_tokens"], b)
        return Batch(clip_ids(self.seed, k, b, mix["clips"]),
                     [self.prompt(rng, q, t) for q, t in zip(qs, ts)],
                     answer_length(self.seed, k, *mix["answer_tokens"]))

    def largest(self) -> Batch:
        """A batch at the mix's largest prompts and answers."""
        mix, b = self.mix, self.mix["batch"]
        rng = seeded(self.seed, "largest")
        return Batch(np.arange(b) % mix["clips"],
                     [self.prompt(rng, mix["question_tokens"][1],
                                  mix["transcript_tokens"][1])
                      for _ in range(b)],
                     mix["answer_tokens"][1])


def program_config(cfg: dict):
    """The program's VideoLLaVAConfig for configuration file `cfg`."""
    from video_llava_tpu_torch.config import (
        CLIPVisionConfig,
        LlamaConfig,
        VideoLLaVAConfig,
    )

    v = cfg["vision_config"]
    return VideoLLaVAConfig(
        vision=CLIPVisionConfig(
            image_size=v["image_size"], patch_size=v["patch_size"],
            hidden_size=v["hidden_size"],
            intermediate_size=v["intermediate_size"],
            num_layers=v["num_hidden_layers"],
            num_heads=v["num_attention_heads"],
            layer_norm_eps=v["layer_norm_eps"], hidden_act=v["hidden_act"],
            projection_dim=v["projection_dim"]),
        llm=LlamaConfig(
            vocab_size=cfg["vocab_size_served"],
            hidden_size=cfg["hidden_size"],
            intermediate_size=cfg["intermediate_size"],
            num_layers=cfg["num_hidden_layers"],
            num_heads=cfg["num_attention_heads"],
            num_kv_heads=cfg["num_key_value_heads"],
            head_dim=cfg["head_dim"],
            max_position_embeddings=cfg["max_position_embeddings"],
            rms_norm_eps=cfg["rms_norm_eps"], rope_theta=cfg["rope_theta"]),
        projector_type=cfg["mm_projector_type"], use_vid_start_end=True,
        max_temporal_tokens=cfg["max_temporal_tokens"],
        vid_patch_token_id=cfg["vid_patch_token_id"],
        vid_start_token_id=cfg["vid_start_token_id"],
        vid_end_token_id=cfg["vid_end_token_id"])


@torch.no_grad()
def build_engine(cfg: dict, mix: dict, seed: int, device,
                 dtype=torch.bfloat16):
    """The program's InferenceEngine over the seed's weights, loaded as a
    checkpoint is: the program's converters write (and, for an int4
    LLM, quantize) the checkpoint-layout tensors that
    portbench/weights.py draws, one unit at a time. `dtype` is the
    served one (the CPU tests also build it in float32)."""
    from video_llava_tpu_torch.config import GenerationConfig
    from video_llava_tpu_torch.engine.weights import (
        convert_clip_vision,
        convert_llama,
        convert_projector,
    )
    from video_llava_tpu_torch.models.video_llava import VideoLLaVA
    from video_llava_tpu_torch.runtime.inference import InferenceEngine
    from video_llava_tpu_torch.runtime.tokenizer import ByteTokenizer

    vcfg = program_config(cfg)
    quant = None if mix["llm_weights"] == "bf16" else mix["llm_weights"]
    model = VideoLLaVA(vcfg, device=device, dtype=dtype, llm_quant=quant)
    convert_clip_vision(weights.shards(
        seed, weights.clip_units(cfg["vision_config"]), device),
        model.vision)
    convert_projector(next(weights.shards(
        seed, weights.projector_units(cfg), device)), model.projector)
    convert_llama(weights.llm_shards(seed, cfg, device), model.llm)
    return InferenceEngine(
        model=model, cfg=vcfg, tokenizer=ByteTokenizer(),
        gen=GenerationConfig(eos_token_id=cfg["eos_token_id"],
                             pad_token_id=cfg["pad_token_id"]),
        cache_dtype=dtype, speculative=False)


def clip_pool(seed: int, mix: dict, device) -> np.ndarray:
    """The seed's clips, (clips, frames, size, size, 3) uint8, drawn on
    the device in one call and kept on the host, as loaded videos are."""
    s = mix["frame_size"]
    g = weights.generator(seed, "clips", device)
    x = torch.randint(0, 256, (mix["clips"], mix["frames"], s, s, 3),
                      dtype=torch.uint8, generator=g, device=device)
    return x.cpu().numpy()


class QACell:
    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device = torch.device(device)
        self.plan = Plan(cfg, mix, seed)
        self.engine = build_engine(cfg, mix, seed, self.device)
        self.pool = clip_pool(seed, mix, self.device)
        self.last = time.perf_counter_ns()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, k: int, batch: Batch) -> dict:
        """One call of the runner's body; its record."""
        from video_llava_tpu_torch.config import GenerationConfig

        eng, cfg = self.engine, self.cfg
        b = len(batch.prompts)
        frames = self.pool[batch.clips]
        lens = [len(p) for p in batch.prompts]
        pad = eng.seq_pad_multiple
        bucket = -(-max(lens) // pad) * pad
        ids = np.full((b, bucket), cfg["pad_token_id"], np.int64)
        for r, p in enumerate(batch.prompts):
            ids[r, :len(p)] = p
        gen = GenerationConfig(max_new_tokens=batch.answer, temperature=0.0,
                               do_sample=False, eos_token_id=-1,
                               pad_token_id=cfg["pad_token_id"])
        t0 = time.perf_counter_ns()
        with torch.inference_mode():
            feats = eng.batched_encode(frames, [frames.shape[1]] * b)
            self._sync()
            t1 = time.perf_counter_ns()
            res = eng.generate_tokens(
                torch.from_numpy(ids).to(self.device),
                torch.tensor(lens, dtype=torch.int32, device=self.device),
                feats, gen, seed=k)
            tokens = res.tokens.cpu().numpy()
            lengths = res.lengths.cpu().numpy()
        t2 = time.perf_counter_ns()
        complete = lengths == batch.answer
        rec = {
            "kind": "qa", "attempted": b, "failed": int((~complete).sum()),
            "answers": int(complete.sum()),
            "latency_s": (t2 - t0) / 1e9, "encode_s": (t1 - t0) / 1e9,
            "generate_s": (t2 - t1) / 1e9,
            "batch": b, "frames": int(frames.shape[1]), "prompt_lens": lens,
            "s_pad": bucket, "answer_len": batch.answer,
            "spans": [("harness: batch assembly", self.last, t0),
                      ("engine.batched_encode", t0, t1),
                      ("engine.generate_tokens", t1, t2)],
            "requests": [{"clip": int(c), "prompt": p,
                          "tokens": tokens[r, :batch.answer]}
                         for r, (c, p) in enumerate(zip(batch.clips,
                                                        batch.prompts))],
        }
        self.last = t2
        return rec

    def warm(self) -> None:
        self.run(-1, self.plan.largest())
        self.last = time.perf_counter_ns()

    def step(self, k: int) -> dict:
        return self.run(k, self.plan.batch(k))

    def free(self) -> None:
        self.engine = None

    def sample(self, records: List[dict]) -> List[dict]:
        """The requests the reference reads: the longest answer (the
        first of them) and a seeded draw of the others."""
        reqs = [q for r in records for q in r["requests"]]
        n = min(self.mix["check"]["requests"], len(reqs))
        longest = max(range(len(reqs)), key=lambda i: len(reqs[i]["tokens"]))
        rest = [i for i in range(len(reqs)) if i != longest]
        pick = seeded(self.seed, "check").choice(len(rest), n - 1,
                                                 replace=False)
        return [reqs[longest]] + [reqs[rest[i]] for i in sorted(pick)]

    @torch.no_grad()
    def widest_gaps(self, reqs: List[dict], control: bool) -> Dict[str, float]:
        """The widest gap of the served tokens below the reference's best
        logit; with `control`, also that of the tokens that the control
        (the reference one precision step lower, run over the same
        prompts and served tokens) puts first at each position."""
        cfg, dev = self.cfg, self.device
        precs = {"reference": ref.REFERENCE}
        if control:
            precs["control"] = ref.CONTROL
        logits = {}
        for name, prec in precs.items():
            video = {c: ref.video_tokens(
                self.seed, cfg, torch.from_numpy(self.pool[c]).to(dev), prec)
                for c in sorted({q["clip"] for q in reqs})}
            rows = []
            for q in reqs:
                p, t = q["prompt"], q["tokens"]
                rows.append({
                    "ids": torch.from_numpy(np.concatenate([p, t[:-1]])).to(
                        dev),
                    "prompt_len": len(p), "video": video[q["clip"]],
                    "at": torch.arange(len(p) - 1, len(p) - 1 + len(t),
                                       device=dev)})
            logits[name] = ref.decoder_logits(self.seed, cfg, rows, prec)
            del video, rows
        served = [torch.from_numpy(q["tokens"]).to(dev) for q in reqs]
        out = {"served": max(float(ref.served_gaps(lg, t).max())
                             for lg, t in zip(logits["reference"], served))}
        if control:
            out["control"] = max(
                float(ref.served_gaps(lg, c.argmax(-1)).max())
                for lg, c in zip(logits["reference"], logits["control"]))
        return out

    def check(self, records: List[dict], control: bool = False) -> dict:
        """The served answers judged by the widest gap; with `control`,
        the control's answers judged in their place by the same limit
        (the program's verdict kept under ``program``)."""
        limit = self.mix["check"]["widest_gap_limit"]
        failed = sum(r["failed"] for r in records)
        gaps = self.widest_gaps(self.sample(records), control)

        def verdict(gap: float) -> dict:
            checks = {"incomplete_answers": {"value": failed, "limit": 0},
                      "widest_gap": {"value": gap, "limit": limit}}
            ok = failed == 0 and bool(np.isfinite(gap)) and gap <= limit
            return {"correct": ok, "checks": checks}

        if not control:
            return verdict(gaps["served"])
        return {**verdict(gaps["control"]),
                "program": verdict(gaps["served"])}


def build(cfg: dict, mix: dict, seed: int, device) -> QACell:
    return QACell(cfg, mix, seed, device)
