"""Operations and bytes counted from shapes, and the H100's peaks.

A kernel's bound is the larger of the bytes it must move over the HBM
rate and its operations over the dense peak of the number format it
runs in, counted as the repository's kernel table (PERF.md, "Every TPU
kernel") counts them: each input byte read once, each output byte
written once. The model's operations (for the step's share of the peak)
count the useful work of the shapes: real tokens, not padding; causal
attention over the keys each query may see. The metric readers
(portbench/metrics/) call these with the configuration and the shapes
that each step's record holds.
"""

from __future__ import annotations

from typing import Dict, Iterable

# Published peaks of one NVIDIA H100 SXM (dense, no sparsity), at the
# full 700 W power limit.
HBM_RATE = 3.35e12  # bytes/s
PEAKS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}


def bound_s(nbytes: float, ops: float, fmt: str) -> float:
    """The least seconds a call could take."""
    return max(nbytes / HBM_RATE, ops / PEAKS[fmt])


def peak_seconds(ops: Dict[str, float]) -> float:
    """Seconds the work would take at each format's peak, summed."""
    return sum(n / PEAKS[fmt] for fmt, n in ops.items())


def add(total: Dict[str, float], part: Dict[str, float]) -> Dict[str, float]:
    for k, v in part.items():
        total[k] = total.get(k, 0.0) + v
    return total


# -- kernels ------------------------------------------------------------------


def clip_attn_call(bh: int, s_pad: int, kv: int, d: int):
    """Kernel 1 (csrc/flash_bhsd.cu), bf16: (bytes, operations) of one
    call over bh heads: q and o at s_pad rows, k and v at kv rows; QK^T
    and PV over s_pad queries and kv keys."""
    return (2 * s_pad + 2 * kv) * bh * d * 2, 4 * bh * s_pad * kv * d


def w4a8_block_call(nb: int, d_in: int, f: int, group: int = 128,
                    out_bytes: int = 2):
    """Kernel B (csrc/w4a8_block.cu): (bytes, int8 operations) of one
    call: the packed int4 weight (d_in/2, f), its bf16 group scales, the
    bf16 activations (nb, d_in) and the output (nb, f)."""
    n_groups = d_in // group
    nbytes = (d_in // 2) * f + 2 * n_groups * f + 2 * nb * d_in \
        + nb * f * out_bytes
    return nbytes, 2 * nb * d_in * f


def flash_calls(b: int, s: int, h: int, h_kv: int, d: int):
    """Kernels 7 and 8 (csrc/flash_attention.cu), bf16, causal over s
    rows: {kernel: (bytes, operations)} of one call of the forward, dq
    and dk/dv, as the kernel table counts them: q and o (and dq, dout)
    at h heads, k and v (and dk, dv) at h_kv heads, the f32 row
    statistics; 2, 3 and 4 products over the pairs the mask lets
    through."""
    pairs = s * (s + 1) // 2
    prod = 2 * b * h * pairs * d
    qb, kb, sb = 2 * b * s * h * d, 2 * b * s * h_kv * d, 4 * b * h * s
    return {"fwd": (2 * qb + 2 * kb + sb, 2 * prod),
            "dq": (3 * qb + 2 * kb + 2 * sb, 3 * prod),
            "dkv": (2 * qb + 4 * kb + 2 * sb, 4 * prod)}


def clip_padded_length(s: int) -> int:
    """The tower's once-padded sequence length: a multiple of 16 up to
    512, of 128 beyond."""
    s_pad = -(-s // 16) * 16
    return -(-s // 128) * 128 if s_pad > 512 else s_pad


# -- model shapes -------------------------------------------------------------


def llm_linears(cfg: dict):
    """{name: (in, out)} of one decoder layer's linears."""
    d, f, hd = cfg["hidden_size"], cfg["intermediate_size"], cfg["head_dim"]
    q, kv = cfg["num_attention_heads"] * hd, cfg["num_key_value_heads"] * hd
    return {"wq": (d, q), "wk": (d, kv), "wv": (d, kv), "wo": (q, d),
            "gate": (d, f), "up": (d, f), "down": (f, d)}


def llm_layer_params(cfg: dict) -> int:
    return sum(i * o for i, o in llm_linears(cfg).values())


def served_vocab(cfg: dict) -> int:
    """The vocab the model serves: the published one, the added video
    tokens and the padding."""
    return cfg["vocab_size_served"]


def clip_frame_ops(v: dict) -> Dict[str, float]:
    """One frame through the tower to its penultimate layer: the patch
    product in f32 (the program runs it on f32 pixels), the encoder
    layers' linears and attention in bf16, over the real tokens."""
    d, f, p = v["hidden_size"], v["intermediate_size"], v["patch_size"]
    patches = (v["image_size"] // p) ** 2
    n = patches + 1
    layers = v["num_hidden_layers"] - 1
    linear = 2 * n * (4 * d * d + 2 * d * f)
    attn = 4 * n * n * d
    return {"f32": 2 * patches * 3 * p * p * d,
            "bf16": layers * (linear + attn)}


def qa_batch_ops(cfg: dict, frames: int, prompt_lens: Iterable[int],
                 answer_len: int) -> Dict[str, float]:
    """Model operations of one batched-QA call, by number format: the
    tower over every frame of every video, the projector, the prefill
    of each prompt (int8 W4A8 linears, f32 causal attention, the bf16
    head at the last position), then answer_len - 1 decode steps a row
    (int8 linears, bf16 attention over the cache, the bf16 head)."""
    v = cfg["vision_config"]
    hd, h = cfg["head_dim"], cfg["num_attention_heads"]
    nl, d = cfg["num_hidden_layers"], cfg["hidden_size"]
    layer = llm_layer_params(cfg)
    vocab = served_vocab(cfg)
    video_tokens = (v["image_size"] // v["patch_size"]) ** 2 \
        + cfg["max_temporal_tokens"]
    ops: Dict[str, float] = {}
    lens = list(prompt_lens)
    for _ in lens:
        add(ops, {k: frames * x for k, x in clip_frame_ops(v).items()})
        add(ops, {"bf16": 2 * video_tokens * cfg["mm_hidden_size"] * d})
    for s in lens:
        add(ops, {"int8": 2 * s * layer * nl,
                  "f32": 2 * h * hd * s * (s + 1) * nl,
                  "bf16": 2 * d * vocab})
        for t in range(1, answer_len):
            ctx = s + t
            add(ops, {"int8": 2 * layer * nl, "bf16": 4 * h * hd * ctx * nl
                      + 2 * d * vocab})
    return ops


def train_step_ops(cfg: dict, lens: Iterable[int],
                   targets: int) -> Dict[str, float]:
    """Model operations of one projector-training step over rows of
    `lens` real tokens with `targets` answer tokens in all, by format:
    the projector (f32: the features are f32) forward and its weight's
    gradient; the frozen decoder's bf16 linears and causal attention
    forward and their input gradients (attention's backward is twice
    its forward); the head at the target positions, forward and input
    gradient. The recomputed forward is not counted."""
    nl, d, h, hd = (cfg["num_hidden_layers"], cfg["hidden_size"],
                    cfg["num_attention_heads"], cfg["head_dim"])
    v = cfg["vision_config"]
    video = (v["image_size"] // v["patch_size"]) ** 2 \
        + cfg["max_temporal_tokens"]
    layer = llm_layer_params(cfg)
    ops: Dict[str, float] = {}
    for n in lens:
        add(ops, {"f32": 2 * 2 * video * cfg["mm_hidden_size"] * d,
                  "bf16": nl * (2 * 2 * n * layer
                                + 3 * 2 * h * hd * n * (n + 1))})
    add(ops, {"bf16": 2 * 2 * targets * d * served_vocab(cfg)})
    return ops

