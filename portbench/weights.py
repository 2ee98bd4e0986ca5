"""Seeded weights in the layout of a released checkpoint.

The benchmark makes the weights, not the program: every tensor of a
configuration is drawn on the device from ``--seed``, in bfloat16, under
the name and in the layout that a Hugging Face checkpoint gives it
(torch Linear weights (out, in), CLIP's patch embedding as a conv
weight). The program loads them through its own checkpoint converters,
as it loads a released model; the reference draws the same tensors
again after the window and works out from them what the program derived.

A *unit* is a group of tensors drawn together: one generator seeded from
(seed, unit name), one normal draw of the unit's whole size, sliced and
scaled. The same seed and unit give the same bits on the same device, in
any order of units.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Iterator, List, Tuple

import torch

# (name, shape, kind, std): kind 'w' is std * N(0, 1); 'one' is
# 1 + std * N(0, 1) (a norm's scale); 'zero' is std * N(0, 1) (a bias).
Leaf = Tuple[str, Tuple[int, ...], str, float]

NORM_STD = 0.05  # spread of norm scales around 1
BIAS_STD = 0.02


def generator(seed: int, unit: str, device) -> torch.Generator:
    """A generator on `device` seeded from (seed, unit)."""
    digest = hashlib.sha256(f"{int(seed)}/{unit}".encode()).digest()
    return torch.Generator(device=device).manual_seed(
        int.from_bytes(digest[:8], "little") >> 1)


def draw_unit(seed: int, unit: str, leaves: List[Leaf],
              device) -> Dict[str, torch.Tensor]:
    """The unit's tensors, bf16, on `device`: one normal draw of their
    total size, then each slice scaled (and shifted for a norm)."""
    total = sum(_numel(shape) for _, shape, _, _ in leaves)
    flat = torch.empty(total, dtype=torch.bfloat16, device=device)
    flat.normal_(0.0, 1.0, generator=generator(seed, unit, device))
    out, at = {}, 0
    for name, shape, kind, std in leaves:
        n = _numel(shape)
        x = flat[at:at + n].view(shape).float() * std
        if kind == "one":
            x = x + 1.0
        out[name] = x.to(torch.bfloat16)
        at += n
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


# -- CLIP vision tower (HF CLIPVisionModel names) ---------------------------


def clip_units(v: dict) -> List[Tuple[str, List[Leaf]]]:
    """[(unit, leaves)] of the vision tower of config group `v`
    (``vision_config``), prefix 'vision_model.'."""
    d, f = v["hidden_size"], v["intermediate_size"]
    p = v["patch_size"]
    pos = (v["image_size"] // p) ** 2 + 1
    pre = "vision_model."
    units = [("clip.embed", [
        (pre + "embeddings.class_embedding", (d,), "w", 0.02),
        (pre + "embeddings.patch_embedding.weight", (d, 3, p, p), "w",
         (3 * p * p) ** -0.5),
        (pre + "embeddings.position_embedding.weight", (pos, d), "w", 0.02),
        (pre + "pre_layrnorm.weight", (d,), "one", NORM_STD),
        (pre + "pre_layrnorm.bias", (d,), "zero", BIAS_STD),
        (pre + "post_layernorm.weight", (d,), "one", NORM_STD),
        (pre + "post_layernorm.bias", (d,), "zero", BIAS_STD),
    ])]
    for i in range(v["num_hidden_layers"]):
        lp = f"{pre}encoder.layers.{i}."
        leaves: List[Leaf] = []
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            leaves += [(f"{lp}self_attn.{n}.weight", (d, d), "w", d ** -0.5),
                       (f"{lp}self_attn.{n}.bias", (d,), "zero", BIAS_STD)]
        leaves += [
            (lp + "mlp.fc1.weight", (f, d), "w", d ** -0.5),
            (lp + "mlp.fc1.bias", (f,), "zero", BIAS_STD),
            (lp + "mlp.fc2.weight", (d, f), "w", f ** -0.5),
            (lp + "mlp.fc2.bias", (d,), "zero", BIAS_STD),
        ]
        for n in ("layer_norm1", "layer_norm2"):
            leaves += [(f"{lp}{n}.weight", (d,), "one", NORM_STD),
                       (f"{lp}{n}.bias", (d,), "zero", BIAS_STD)]
        units.append((f"clip.layer.{i}", leaves))
    return units


def projector_units(cfg: dict) -> List[Tuple[str, List[Leaf]]]:
    """The linear mm_projector, reference checkpoint names."""
    c, d = cfg["mm_hidden_size"], cfg["hidden_size"]
    return [("projector", [
        ("model.mm_projector.weight", (d, c), "w", c ** -0.5),
        ("model.mm_projector.bias", (d,), "zero", BIAS_STD),
    ])]


# -- the LLM (HF LlamaForCausalLM / MistralForCausalLM names) -----------------


def llm_top_units(cfg: dict) -> List[Tuple[str, List[Leaf]]]:
    d, vocab = cfg["hidden_size"], cfg["vocab_size"]
    return [("llm.embed", [("model.embed_tokens.weight", (vocab, d), "w",
                            0.02)]),
            ("llm.head", [("lm_head.weight", (vocab, d), "w", d ** -0.5),
                          ("model.norm.weight", (d,), "one", NORM_STD)])]


def llm_layer_leaves(cfg: dict, i: int) -> List[Leaf]:
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    hd = cfg["head_dim"]
    q, kv = cfg["num_attention_heads"] * hd, cfg["num_key_value_heads"] * hd
    lp = f"model.layers.{i}."
    return [
        (lp + "self_attn.q_proj.weight", (q, d), "w", d ** -0.5),
        (lp + "self_attn.k_proj.weight", (kv, d), "w", d ** -0.5),
        (lp + "self_attn.v_proj.weight", (kv, d), "w", d ** -0.5),
        (lp + "self_attn.o_proj.weight", (d, q), "w", q ** -0.5),
        (lp + "mlp.gate_proj.weight", (f, d), "w", d ** -0.5),
        (lp + "mlp.up_proj.weight", (f, d), "w", d ** -0.5),
        (lp + "mlp.down_proj.weight", (d, f), "w", f ** -0.5),
        (lp + "input_layernorm.weight", (d,), "one", NORM_STD),
        (lp + "post_attention_layernorm.weight", (d,), "one", NORM_STD),
    ]


def llm_layer(seed: int, cfg: dict, i: int, device) -> Dict[str, torch.Tensor]:
    return draw_unit(seed, f"llm.layer.{i}", llm_layer_leaves(cfg, i), device)


def llm_shards(seed: int, cfg: dict,
               device) -> Iterator[Dict[str, torch.Tensor]]:
    """The LLM as checkpoint shards, one unit at a time, so that no more
    than one layer's bf16 tensors live beside the program's model."""
    for unit, leaves in llm_top_units(cfg):
        yield draw_unit(seed, unit, leaves, device)
    for i in range(cfg["num_hidden_layers"]):
        yield llm_layer(seed, cfg, i, device)


def shards(seed: int, units, device) -> Iterator[Dict[str, torch.Tensor]]:
    for unit, leaves in units:
        yield draw_unit(seed, unit, leaves, device)
