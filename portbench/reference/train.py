"""The plain reference of projector training, in float32.

The first steps of the trainer on the same rows: the video features
through the linear projector, spliced into the token embeddings at the
<vid_patch> positions, the frozen decoder (reference/model.py's layer,
causal over each row's own tokens, no padding), the untied head and the
shifted cross-entropy over the answer tokens of all rows; the gradients
of the projector and the token embeddings by backpropagation, each
decoder layer recomputed row by row from its stored input; then AdamW
(optax's update, in f32) under the warmup-cosine schedule. The weights
are drawn again from the seed (portbench/weights.py), in f32 from their
bf16 values; nothing of the program is imported.

Returns, for the steps given: each step's loss, each trained leaf's
first gradient (and its norm), and each leaf's change norm after the
last step, under the program's leaf names.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from portbench import weights
from portbench.reference.model import _attend, _grown, _rms_norm, _rope

IGNORE = -100
LEAVES = ("projector.layers.0.kernel", "projector.layers.0.bias",
          "llm.embed_tokens.weight")


def schedule(count: int, mix: dict) -> float:
    """optax's warmup-cosine learning rate at the update count (linear
    warmup from 0, then cosine decay to 0 over the remaining steps)."""
    peak, warm = mix["learning_rate"], mix["warmup_steps"]
    total = max(mix["total_steps"], warm + 1)
    if count < warm:
        return peak * count / warm
    c = min(count - warm, total - warm)
    return peak * 0.5 * (1 + math.cos(math.pi * c / (total - warm)))


def _layer(x, p, lp, cfg):
    """One decoder layer over a row: x (n, d) f32, HF-layout weights."""
    n = x.shape[0]
    h, h_kv, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                   cfg["head_dim"])
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]

    def lin(name, t):
        return t @ p[lp + name].t()

    hn = _rms_norm(x, p[lp + "input_layernorm.weight"], eps)
    pos = torch.arange(n, device=x.device)
    q = _rope(lin("self_attn.q_proj.weight", hn).view(n, h, hd), pos, theta)
    k = _rope(lin("self_attn.k_proj.weight", hn).view(n, h_kv, hd), pos,
              theta)
    v = lin("self_attn.v_proj.weight", hn).view(n, h_kv, hd)
    x = x + lin("self_attn.o_proj.weight", _attend(q, k, v).reshape(n, -1))
    hn = _rms_norm(x, p[lp + "post_attention_layernorm.weight"], eps)
    g = F.silu(lin("mlp.gate_proj.weight", hn)) * lin("mlp.up_proj.weight",
                                                      hn)
    return x + lin("mlp.down_proj.weight", g)


def _f32(t: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.float() for k, v in t.items()}


def reference_steps(seed: int, cfg: dict, mix: dict, batches: List[dict],
                    device) -> Dict[str, object]:
    """Train the reference for len(batches) steps; see the module."""
    vocab = cfg["vocab_size_served"]
    nl = cfg["num_hidden_layers"]
    proj = _f32(next(weights.shards(seed, weights.projector_units(cfg),
                                    device)))
    top = dict(weights.llm_top_units(cfg))
    table = weights.draw_unit(seed, "llm.embed", top["llm.embed"], device)[
        "model.embed_tokens.weight"]
    head = weights.draw_unit(seed, "llm.head", top["llm.head"], device)
    norm_w = head["model.norm.weight"].float()
    lm = _grown(head["lm_head.weight"], vocab).float()  # (vocab, d)
    params = {LEAVES[0]: proj["model.mm_projector.weight"].t().contiguous(),
              LEAVES[1]: proj["model.mm_projector.bias"],
              LEAVES[2]: _grown(table, vocab).float()}
    start = {n: t.clone() for n, t in params.items()}
    mu = {n: torch.zeros_like(t) for n, t in params.items()}
    nu = {n: torch.zeros_like(t) for n, t in params.items()}
    b1, b2, eps_adam = 0.9, 0.999, 1e-8
    out: Dict[str, object] = {"loss": []}
    for step, batch in enumerate(batches):
        leaves = {n: t.clone().requires_grad_() for n, t in params.items()}
        rows = []
        for (ids, labels), feats in zip(batch["rows"],
                                        batch["video_features"]):
            ids_t = torch.from_numpy(ids).to(device)
            video = torch.from_numpy(feats).to(device) @ leaves[LEAVES[0]] \
                + leaves[LEAVES[1]]
            patch = ids_t == cfg["vid_patch_token_id"]
            x0 = leaves[LEAVES[2]][ids_t]
            x0 = torch.where(patch[:, None],
                             video[(torch.cumsum(patch.long(), 0) - 1)
                                   .clamp(0, len(video) - 1)], x0)
            rows.append({"x0": x0, "labels": torch.from_numpy(labels).to(
                device)})
        count = sum(int((r["labels"][1:] != IGNORE).sum()) for r in rows)
        # forward, each layer's input kept
        xs = [[r["x0"].detach() for r in rows]]
        with torch.no_grad():
            for li in range(nl):
                p = _f32(weights.llm_layer(seed, cfg, li, device))
                xs.append([_layer(x, p, f"model.layers.{li}.", cfg)
                           for x in xs[-1]])
                del p
        # the loss and its gradient at the last layer's output
        loss, grads = 0.0, []
        for r, x in zip(rows, xs[-1]):
            x = x.clone().requires_grad_()
            logits = _rms_norm(x, norm_w, cfg["rms_norm_eps"]) @ lm.t()
            tgt = r["labels"][1:]
            valid = tgt != IGNORE
            logp = torch.log_softmax(logits[:-1], -1)
            ll = logp[valid].gather(-1, tgt[valid][:, None]).sum()
            part = -ll / count
            grads.append(torch.autograd.grad(part, x)[0])
            loss += float(part.detach())
            del logits, logp
        out["loss"].append(loss)
        # back through the layers, each recomputed row by row
        for li in reversed(range(nl)):
            p = _f32(weights.llm_layer(seed, cfg, li, device))
            nxt = []
            for x, g in zip(xs[li], grads):
                x = x.clone().requires_grad_()
                y = _layer(x, p, f"model.layers.{li}.", cfg)
                nxt.append(torch.autograd.grad(y, x, g)[0])
            grads = nxt
            xs.pop()
            del p
        torch.autograd.backward([r["x0"] for r in rows], grads)
        g = {n: leaves[n].grad for n in LEAVES}
        if step == 0:
            out["grad"] = {n: float(g[n].norm()) for n in LEAVES}
            out["grad_vec"] = {n: g[n].detach().clone() for n in LEAVES}
        lr = schedule(step, mix)
        c = step + 1
        for n in LEAVES:
            mu[n] = (1 - b1) * g[n] + b1 * mu[n]
            nu[n] = (1 - b2) * g[n] * g[n] + b2 * nu[n]
            u = (mu[n] / (1 - b1 ** c)) / (
                torch.sqrt(nu[n] / (1 - b2 ** c)) + eps_adam)
            u = u + mix["weight_decay"] * params[n]
            params[n] = params[n] - lr * u
        del leaves, rows, xs, grads, g
    out["change"] = {n: float((params[n] - start[n]).norm())
                     for n in LEAVES}
    return out
