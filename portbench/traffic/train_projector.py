"""Projector training on precomputed video features, the trainer's step.

Each step is one call of ``train/train_step.make_train_step``'s step
(the loss with every decoder layer recomputed in the backward pass,
the gradients of the trainable set, AdamW in the parameters' dtype) on
a batch that ``train/data.Collator`` pads, moved to the card as the
trainer's iterator moves it; the step counts once its loss is on the
host. The model is the configuration's in bf16, loaded as a checkpoint
is (portbench/weights.py through the program's converters); the LLM is
frozen and the projector and token embeddings train (the reference's
recipe, ``tune_mode`` projector+embed).

The mix's parameters (``portbench/traffic/<mix>.json``): ``rows`` a
step; each row the template (``template_tokens``), a question of
``question_tokens`` [lo, hi], the <vid_start>, the video tokens and
<vid_end>, then an answer that brings the conversation to
``conversation_tokens`` [lo, hi]; the answer's tokens are the targets.
Video features are f32, drawn from the seed. ``llm_weights``,
``tune_mode``, ``learning_rate``, ``weight_decay``, ``warmup_steps``,
``total_steps``; ``check``: the limits of the three numbers compared.
Every step's rows take the mix's lengths spread evenly over their
ranges, in a seeded order. A step's record holds its shapes (``rows``,
each row's ``lens``, the answer ``targets``, the padded ``s_pad``),
which the metric readers count operations and bytes from.

Set-up builds the training state and drives it through the first
``CHECKED`` steps of the traffic with the window's own call; the window
goes on from there with the same state. The check compares those steps
with the plain reference (reference/train.py): each step's loss, the
first gradient per trained leaf (from AdamW's first moment after one
step), by the gap of its norm and by the norm of its difference, and
the norm of each leaf's change after the checked steps.
"""

from __future__ import annotations

import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import weights
from portbench.reference import train as ref_train
from portbench.traffic.batched_qa import Plan, program_config, seeded, spread

CHECKED = 3  # steps the reference follows


class TrainPlan(Plan):
    """The seed's rows: prompt ids, labels, video features."""

    def batch(self, k: int) -> Dict[str, np.ndarray]:
        mix, cfg = self.mix, self.cfg
        rng = seeded(self.seed, "batch", k)
        n = mix["rows"]
        qs = spread(rng, *mix["question_tokens"], n)
        convs = spread(rng, *mix["conversation_tokens"], n)
        rows = []
        for q, c in zip(qs, convs):
            prompt = np.concatenate([[cfg["bos_token_id"]], self.before,
                                     self.draw(rng, q), self.video,
                                     self.after])
            answer = self.draw(rng, c - q)
            ids = np.concatenate([prompt, answer]).astype(np.int64)
            labels = np.full(len(ids), -100, np.int64)
            labels[len(prompt):] = answer
            rows.append((ids, labels))
        v = self.cfg["vision_config"]
        tokens = (v["image_size"] // v["patch_size"]) ** 2 \
            + cfg["max_temporal_tokens"]
        g = np.random.default_rng(rng.integers(0, 2 ** 63))
        feats = g.standard_normal((n, tokens, cfg["mm_hidden_size"]),
                                  dtype=np.float32)
        return {"rows": rows, "video_features": feats}


def collate(batch: dict, pad_id: int) -> Dict[str, np.ndarray]:
    """The trainer's Collator over the batch's rows."""
    from video_llava_tpu_torch.train.data import Collator

    inst = [{"input_ids": ids, "labels": lab, "video_features": f}
            for (ids, lab), f in zip(batch["rows"], batch["video_features"])]
    return Collator(pad_id)(inst)


@torch.no_grad()
def build_model(cfg: dict, mix: dict, seed: int, device):
    """The program's VideoLLaVA for training, its weights loaded as a
    checkpoint is; a frozen int8 LLM where the mix says so (the
    trainer's --llm_weights int8: every LLM linear int8, embed_tokens
    kept bf16)."""
    from video_llava_tpu_torch.engine.weights import (
        convert_clip_vision,
        convert_llama,
        convert_projector,
    )
    from video_llava_tpu_torch.models.video_llava import VideoLLaVA

    int8 = mix["llm_weights"] == "int8"
    model = VideoLLaVA(program_config(cfg), device=device,
                       dtype=torch.bfloat16,
                       llm_quant="int8" if int8 else None,
                       llm_skip_keys=("embed_tokens",) if int8 else ())
    convert_clip_vision(weights.shards(
        seed, weights.clip_units(cfg["vision_config"]), device),
        model.vision)
    convert_projector(next(weights.shards(
        seed, weights.projector_units(cfg), device)), model.projector)
    convert_llama(weights.llm_shards(seed, cfg, device), model.llm)
    return model


class TrainCell:
    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        from video_llava_tpu_torch.train.train_step import (
            init_train_state,
            make_optimizer,
            make_train_step,
            trainable_mask,
        )

        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device = torch.device(device)
        self.plan = TrainPlan(cfg, mix, seed)
        model = build_model(cfg, mix, seed, self.device)
        names = trainable_mask(model, mix["tune_mode"])
        tx = make_optimizer(mix["learning_rate"], mix["weight_decay"],
                            warmup_steps=mix["warmup_steps"],
                            total_steps=mix["total_steps"])
        self.state = init_train_state(model, tx, names)
        self.step_fn = make_train_step(tx)
        self.b1 = tx.b1
        params = dict(model.named_parameters())
        self.start = {n: params[n].detach().clone() for n in names}
        self.checked: Dict[str, object] = {}
        self.next = 0
        self.last = time.perf_counter_ns()

    def run(self, k: int) -> dict:
        batch = self.plan.batch(k)
        host = collate(batch, self.cfg["pad_token_id"])
        t0 = time.perf_counter_ns()
        dev = {n: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
               for n, v in host.items()}
        self.state, metrics = self.step_fn(self.state, dev)
        loss = float(metrics["loss"])
        t1 = time.perf_counter_ns()
        lens = [len(ids) for ids, _ in batch["rows"]]
        targets = int(sum((lab[1:] != -100).sum() for _, lab in
                          batch["rows"]))
        s_pad = host["input_ids"].shape[1]
        rec = {
            "kind": "train", "attempted": 1,
            "failed": int(not np.isfinite(loss)), "loss": loss,
            "tokens": int(sum(lens)), "step_s": (t1 - t0) / 1e9,
            "rows": len(lens), "lens": lens, "targets": targets,
            "s_pad": s_pad,
            "spans": [("harness: batch assembly", self.last, t0),
                      ("train_step", t0, t1)],
        }
        self.last = t1
        return rec

    def warm(self) -> None:
        """The first CHECKED steps, kept for the check."""
        losses = []
        for k in range(CHECKED):
            losses.append(self.run(k)["loss"])
            if k == 0:  # AdamW's first moment is (1 - b1) g after one step
                self.checked["grad_vec"] = {
                    n: m.detach().clone()
                    for n, m in self.state.opt_state["mu"].items()}
        params = dict(self.state.model.named_parameters())
        self.checked["change"] = {
            n: float((params[n].detach().float() - p0.float()).norm())
            for n, p0 in self.start.items()}
        self.checked["loss"] = losses
        self.start = None
        self.next = CHECKED
        self.last = time.perf_counter_ns()

    def step(self, k: int) -> dict:
        return self.run(self.next + k)

    def free(self) -> None:
        self.state = self.step_fn = None

    def check(self, records: List[dict], control: bool = False) -> dict:
        lim = self.mix["check"]
        batches = [self.plan.batch(k) for k in range(CHECKED)]
        want = ref_train.reference_steps(
            self.seed, self.cfg, self.mix, batches, self.device)
        got = self.checked
        first = {n: m.float() / (1 - self.b1)
                 for n, m in got.pop("grad_vec").items()}
        got["grad"] = {n: float(g.norm()) for n, g in first.items()}
        off = {n: float((first[n] - want["grad_vec"][n]).norm())
               for n in first}
        del first
        loss = max(abs(a - b) / abs(b)
                   for a, b in zip(got["loss"], want["loss"]))
        grad = worst_leaf(got["grad"], want["grad"], want["grad"])
        grad_err = worst_leaf(off, {n: 0.0 for n in off}, want["grad"],
                              scale=want["grad"])
        change = worst_leaf(got["change"], want["change"], want["grad"])
        failed = sum(r["failed"] for r in records)
        checks = {
            "failed_steps": {"value": failed, "limit": 0},
            "loss_rel": {"value": loss, "limit": lim["loss_rel"]},
            "grad_norm_gap": {"value": grad, "limit": lim["grad_norm_gap"]},
            "grad_rel_err": {"value": grad_err,
                             "limit": lim["grad_rel_err"]},
            "change_norm_gap": {"value": change,
                                "limit": lim["change_norm_gap"]},
        }
        correct = failed == 0 and all(
            np.isfinite(c["value"]) and c["value"] <= c["limit"]
            for c in checks.values())
        detail = {"grad_rel_err": {n: off[n] / want["grad"][n] for n in off},
                  "grad": got["grad"], "grad_ref": want["grad"],
                  "change": got["change"], "change_ref": want["change"]}
        return {"correct": correct, "checks": checks, "detail": detail}


def worst_leaf(got: Dict[str, float], want: Dict[str, float],
               grads: Dict[str, float], scale=None) -> float:
    """The largest gap between the program's and the reference's norm of
    a leaf, over the larger of the reference's norm of that leaf and of
    the median leaf (the norms in `scale`, `want` by default); leaves
    whose reference gradient is under a thousandth of the median leaf's
    are left out (they move by round-off alone)."""
    scale = want if scale is None else scale
    med_grad = statistics.median(grads.values())
    keep = [n for n in want if grads[n] >= 1e-3 * med_grad]
    med = statistics.median(scale[n] for n in keep)
    return max(abs(got[n] - want[n]) / max(scale[n], med) for n in keep)


def build(cfg: dict, mix: dict, seed: int, device) -> TrainCell:
    return TrainCell(cfg, mix, seed, device)
