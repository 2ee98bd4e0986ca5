"""Shared fixtures of the learned grounding build's parity tests: tiny
XMem configurations with the JAX package's parameters (BN statistics made
non-trivial) and the same values carried into the port by
engine/convert.xmem_from_jax; tiny CLIP towers carried by
clip_vision_from_jax / clip_text_from_jax; the stub detector, segmenter
and crop filter of the JAX package's fused-clip tests (copied, so that no
test module is imported twice); seeded frames. Not collected (no test_
prefix)."""

import collections
import contextlib
import json

import numpy as np
import jax
import jax.numpy as jnp
import torch

from video_llava_tpu.config import CLIPTextConfig as JTextCfg
from video_llava_tpu.grounding.clip_filter import DEFAULT_TEMPLATES
from video_llava_tpu.config import CLIPVisionConfig as JVisionCfg
from video_llava_tpu.grounding.clip_filter import ClipCropFilter as JFilter
from video_llava_tpu.models import clip as jclip
from video_llava_tpu.models import xmem as jx
from video_llava_tpu_torch.config import CLIPTextConfig, CLIPVisionConfig
from video_llava_tpu_torch.engine.convert import (
    clip_text_from_jax,
    clip_vision_from_jax,
    xmem_from_jax,
)
from video_llava_tpu_torch.grounding.clip_filter import ClipCropFilter
from video_llava_tpu_torch.models import clip as tclip
from video_llava_tpu_torch.models import xmem as tx
from video_llava_tpu_torch.models.layers import TreeInit
from video_llava_tpu_torch.runtime.tokenizer import (
    bytes_to_unicode,
    clip_clean_text,
    clip_pre_tokenize,
)

H, W = 64, 96  # 16-aligned
MAX_O = 4
META = TreeInit(0, "meta")

# tiny CLIP towers (the JAX package's clip-filter test sizes)
VISION_KW = dict(image_size=56, patch_size=14, hidden_size=32,
                 intermediate_size=64, num_layers=2, num_heads=2,
                 projection_dim=16)
TEXT_KW = dict(vocab_size=300, hidden_size=32, intermediate_size=64,
               num_layers=2, num_heads=2, projection_dim=16)


@contextlib.contextmanager
def one_torch_thread():
    """torch on one thread for the test: tiny CPU ops gain nothing from
    more, and the tier's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def perturb_bn(tree, rng):
    """Every BN dict {'scale', 'bias', 'mean', 'var'} of a numpy tree
    drawn away from the identity, so the folding is exercised."""
    if isinstance(tree, list):
        return [perturb_bn(v, rng) for v in tree]
    if not isinstance(tree, dict):
        return tree
    if set(tree) == {"scale", "bias", "mean", "var"}:
        c = np.shape(tree["scale"])
        return {"scale": rng.uniform(0.8, 1.2, c).astype(np.float32),
                "bias": rng.normal(0, 0.05, c).astype(np.float32),
                "mean": rng.normal(0, 0.05, c).astype(np.float32),
                "var": rng.uniform(0.7, 1.3, c).astype(np.float32)}
    return {k: perturb_bn(v, rng) for k, v in tree.items()}


def seeded_tree(shapes, seed: int = 0):
    """A numpy tree of the JAX package's layout (the leaves' shapes from
    jax.eval_shape of its init) drawn from a seed: kernels N(0, 1 /
    fan_in) (HWIO convs' fan_in kh * kw * in, linears' in), biases
    N(0, 0.02^2), BN statistics away from the identity (perturb_bn).
    Cheaper than the JAX init's eager draws, and activations stay of
    moderate size through the untrained trunks."""
    rng = np.random.default_rng(seed)

    def leaf(path, sd):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(sd.shape[:-1]))
            return (rng.normal(size=sd.shape) / np.sqrt(fan_in)).astype(
                np.float32)
        return rng.normal(0, 0.02, sd.shape).astype(np.float32)

    return perturb_bn(jax.tree_util.tree_map_with_path(leaf, shapes), rng)


def xmem_pair(**cfg_kw):
    """((JAX params, JAX cfg), (port params, port cfg), numpy tree) of
    one XMem network with the same values."""
    cfg_kw = {"max_objects": MAX_O, "mem_slots": 4, "top_k": 8, **cfg_kw}
    jcfg, tcfg = jx.XMemConfig(**cfg_kw), tx.XMemConfig(**cfg_kw)
    tree = seeded_tree(jax.eval_shape(lambda k: jx.init_params(k, jcfg),
                                      jax.random.PRNGKey(0)))
    jp = jax.tree.map(jnp.asarray, tree)
    tp = xmem_from_jax(tree, tx.init_params(META, tcfg))
    return (jp, jcfg), (tp, tcfg), tree


def frames(t: int, h: int = H, w: int = W, seed: int = 3) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 255, size=(t, h, w, 3)).astype(np.uint8)


def nchw(x) -> np.ndarray:
    """A JAX (..., H, W, C) array -> numpy (..., C, H, W)."""
    return np.moveaxis(np.asarray(x), -1, -3)


def clip_pair(tokenize, prob_threshold=0.0, score_threshold=-1.0):
    """(JAX ClipCropFilter, port ClipCropFilter) over the same tiny
    towers, projection and tokenizer."""
    vcfg, tcfg = JVisionCfg(**VISION_KW), JTextCfg(**TEXT_KW)
    vparams = jclip.init_vision_params(jax.random.PRNGKey(0), vcfg)
    tparams = jclip.init_text_params(jax.random.PRNGKey(1), tcfg)
    proj = np.random.default_rng(2).normal(size=(32, 16)).astype(np.float32)
    jf = JFilter(vparams, vcfg, tparams, tcfg, tokenize,
                 {"kernel": jnp.asarray(proj)},
                 prob_threshold=prob_threshold,
                 score_threshold=score_threshold)
    ttcfg = CLIPTextConfig(**TEXT_KW)
    tower = clip_vision_from_jax(jax.tree.map(np.asarray, vparams),
                                 CLIPVisionConfig(**VISION_KW))
    text = clip_text_from_jax(jax.tree.map(np.asarray, tparams),
                              tclip.init_text_params(META, ttcfg))
    tf = ClipCropFilter(tower, text, ttcfg, tokenize,
                        {"kernel": torch.from_numpy(proj)},
                        prob_threshold=prob_threshold,
                        score_threshold=score_threshold)
    return jf, tf


def crc32_tokenize(vocab_size: int = TEXT_KW["vocab_size"],
                   maxlen: int = 77):
    """random_clip_filter's hash tokenizer at another vocabulary."""
    import zlib

    def tokenize(s):
        ids = [zlib.crc32(w.encode()) % (vocab_size - 2) + 1
               for w in s.split()]
        return ids[:maxlen - 1] + [vocab_size - 1]

    return tokenize


CLIP_CLASSES = ("Person", "hot-DOG", "Dog's  tail", "T-shirt (red)!",
                "3D printer", "café", "rock'n'roll", "  Cat\tand DOG ",
                "traffic light.", "A.B.C")


def clip_prompts():
    """The crop filter's ten templates over CLIP_CLASSES."""
    return [t.format(c) for c in CLIP_CLASSES for t in DEFAULT_TEMPLATES]


def write_clip_vocab(d, n_merges=80):
    """vocab.json + merges.txt of a BPE learned greedily (most frequent
    pair, ties to the smaller pair) over the prompts' pieces."""
    enc = bytes_to_unicode()
    words = collections.Counter()
    for text in clip_prompts():
        for piece in clip_pre_tokenize(clip_clean_text(text)):
            chars = [enc[b] for b in piece.encode("utf-8")]
            words[tuple(chars[:-1] + [chars[-1] + "</w>"])] += 1
    merges = []
    for _ in range(n_merges):
        pairs = collections.Counter()
        for w, c in words.items():
            for p in zip(w, w[1:]):
                pairs[p] += c
        if not pairs:
            break
        best = min(pairs, key=lambda p: (-pairs[p], p))
        merges.append(best)
        merged = collections.Counter()
        for w, c in words.items():
            out, i = [], 0
            while i < len(w):
                if i < len(w) - 1 and (w[i], w[i + 1]) == best:
                    out.append(w[i] + w[i + 1])
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            merged[tuple(out)] += c
        words = merged
    vocab = list(enc.values())
    vocab += [v + "</w>" for v in vocab]
    vocab += [a + b for a, b in merges]
    vocab += ["<|startoftext|>", "<|endoftext|>"]
    with open(d / "vocab.json", "w", encoding="utf-8") as f:
        json.dump({t: i for i, t in enumerate(vocab)}, f)
    with open(d / "merges.txt", "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    return len(vocab)


class StubDetector:
    """Boxes that move with the call count; distinct areas."""

    def __init__(self):
        self.calls = 0

    def detect_batch(self, images, prompts):
        out = []
        for _ in range(len(images)):
            ti = self.calls
            self.calls += 1
            boxes = np.asarray([[4 + ti, 6, 34 + ti, 32],
                                [50, 20 + ti, 72, 38 + ti],
                                [10, 40, 24, 52]], np.float32)
            out.append((boxes, np.asarray([0.9, 0.7, 0.5], np.float32),
                        np.asarray([0, 1, 0], np.int64)))
        return out

    def __call__(self, image, prompts):
        return self.detect_batch(np.asarray(image)[None], prompts)[0]


class StubSegmenter:
    """Box masks."""

    supports_frame_cache = False
    encode_batch_size = 1

    def __call__(self, image, boxes):
        h, w = image.shape[:2]
        m = np.zeros((len(boxes), h, w), np.float32)
        for i, b in enumerate(boxes):
            x0, y0, x1, y1 = (max(int(v), 0) for v in b)
            m[i, y0:y1, x0:x1] = 1.0
        return m


class StubFilter:
    """Both filter interfaces with the same box-geometry decisions."""

    supports_batch_device = True

    @staticmethod
    def keep(boxes):
        b = np.trunc(np.asarray(boxes, np.float32)).astype(int)
        return (b[..., 0] + b[..., 1]) % 2 == 0

    def __call__(self, image, boxes, class_ids, classes):
        return self.keep(boxes)

    def filter_frames_device(self, frames, boxes, valid, class_ids,
                             classes):
        return self.keep(boxes) & np.asarray(valid, bool)


def same_results(got, want, mask_share=5e-3, soft_atol=5e-3):
    """Frame indices and objects (id, category, score 1e-6) equal; masks
    (soft, or binary uint8) differing by more than soft_atol on under
    mask_share of the pixels of each frame."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.frame_index == w.frame_index
        assert [(o.id, o.category_id) for o in g.objects] == [
            (o.id, o.category_id) for o in w.objects], g.frame_index
        for a, b in zip(g.objects, w.objects):
            assert abs(a.score - b.score) <= 1e-6
        assert g.masks.shape == w.masks.shape, g.frame_index
        bad = np.mean(np.abs(np.asarray(g.masks, np.float32)
                             - np.asarray(w.masks, np.float32)) > soft_atol)
        assert bad < mask_share, (g.frame_index, bad)

