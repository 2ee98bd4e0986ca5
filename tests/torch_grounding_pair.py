"""Tiny grounding models shared by the grounded-chat parity tests: the
JAX package's parameters (the tiny_test configs, drawn as its own tests
draw them) and the same values carried into the port by
engine/convert.tree_from_jax, plus stub detector / segmenter / entity
clients. Not collected (no test_ prefix)."""

import numpy as np
import jax

from video_llava_tpu.grounding import builders as jbuild
from video_llava_tpu.grounding.tagging import init_tag_head as j_init_head
from video_llava_tpu.models import grounding_dino as jgd
from video_llava_tpu.models import sam as jsam
from video_llava_tpu.models import swin as jswin
from video_llava_tpu.models import tiny_vit as jtv
from video_llava_tpu_torch.engine.convert import tree_from_jax
from video_llava_tpu_torch.grounding import builders as tbuild
from video_llava_tpu_torch.grounding.tagging import init_tag_head
from video_llava_tpu_torch.models import grounding_dino as tgd
from video_llava_tpu_torch.models import sam as tsam
from video_llava_tpu_torch.models import swin as tswin
from video_llava_tpu_torch.models import tiny_vit as ttv
from video_llava_tpu_torch.models.layers import TreeInit

META = TreeInit(0, "meta")


def to_port(tree, like):
    """A JAX tree -> the port's tree of tensors, checked against `like`."""
    return tree_from_jax(jax.tree.map(np.asarray, tree), like)


def dino_pair():
    """(JAX params, port params) of the tiny GroundingDINO (random HF
    weights through the JAX converter)."""
    params = jgd._random_params(jgd.GroundingDinoConfig.tiny_test())
    like = tgd.init_params(META, tgd.GroundingDinoConfig.tiny_test())
    return params, to_port(params, like)


def sam_pair():
    """(JAX params, port params) of a tiny MobileSAM: the tiny TinyViT
    encoder plus the tiny SAM prompt encoder and mask decoder."""
    tcfg, scfg = jtv.TinyViTConfig.tiny_test(), jsam.SamConfig.tiny_test()
    params = {"vision": jtv.init_params(jax.random.PRNGKey(0), tcfg)}
    params.update(jbuild._random_sam_decoder_params(scfg))
    like = {"vision": ttv.init_params(META, ttv.TinyViTConfig.tiny_test()),
            **tsam.init_decoder_params(META, tsam.SamConfig.tiny_test())}
    return params, to_port(params, like)


def sam_segmenters(sam_params=None):
    """(JAX SamSegmenter, port SamSegmenter) on the tiny MobileSAM."""
    jp, tp = sam_params or sam_pair()
    tcfg, scfg = jtv.TinyViTConfig.tiny_test(), jsam.SamConfig.tiny_test()
    jseg = jbuild.SamSegmenter(
        jp, scfg, encode_fn=lambda p, px: jtv.encoder(p["vision"], px, tcfg))
    pcfg = ttv.TinyViTConfig.tiny_test()
    tseg = tbuild.SamSegmenter(
        tp, tsam.SamConfig.tiny_test(),
        lambda p, px: ttv.encoder(p["vision"], px, pcfg))
    return jseg, tseg


def tagger_pair(num_tags: int = 20):
    """(JAX (backbone, head), port (backbone, head)) on the tiny Swin."""
    cfg = jswin.SwinConfig.tiny_test()
    backbone = jswin.init_params(jax.random.PRNGKey(0), cfg)
    head = j_init_head(jax.random.PRNGKey(1), cfg.num_features, num_tags)
    tcfg = tswin.SwinConfig.tiny_test()
    like_b = tswin.init_params(META, tcfg)
    like_h = init_tag_head(META, tcfg.num_features, num_tags)
    return (backbone, head), (to_port(backbone, like_b),
                              to_port(head, like_h))


def textured_frames(t: int, h: int, w: int, seed: int = 3):
    """Seeded noise frames: textured, so patch features do not tie."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(t, h, w, 3), dtype=np.uint8)


def patchy_frames(t: int, h: int, w: int, seed: int = 3, patch: int = 8):
    """Seeded frames of random colors per patch plus noise: the STM's
    patch-mean features spread widely, so its top-k has no near ties
    that f32 rounding could reorder."""
    rng = np.random.default_rng(seed)
    cells = rng.integers(0, 256, size=(t, h // patch + 1, w // patch + 1, 3))
    big = np.repeat(np.repeat(cells, patch, axis=1), patch, axis=2)
    noise = rng.integers(-12, 13, size=(t, h, w, 3))
    return np.clip(big[:, :h, :w] + noise, 0, 255).astype(np.uint8)


def moving_squares(t: int, h: int, w: int, seed: int = 0):
    """A fixed seeded background of patch colors with three squares of
    other colors moving across it: one scene for detect_scenes, and the
    STM's unchanged patches tie exactly (broken toward the lower index,
    as jax.lax.top_k does) rather than nearly."""
    rng = np.random.default_rng(seed)
    frames = np.repeat(patchy_frames(1, h, w, seed=seed), t, axis=0)
    for k in range(3):
        color = rng.integers(0, 256, 3)
        y, x = rng.integers(0, h // 2), rng.integers(0, w // 2)
        dy, dx = rng.integers(-2, 3), rng.integers(1, 4)
        size = (h // 4, w // 5, h // 6)[k]
        for i in range(t):
            yy = int(np.clip(y + dy * i, 0, h - size))
            xx = int(np.clip(x + dx * i, 0, w - size))
            frames[i, yy:yy + size, xx:xx + size] = color
    return frames


class StubDetector:
    """Boxes that move with the call count, distinct areas."""

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


class StubClient:
    """An OpenAI-compatible client whose answer pairs a made-up phrase
    with each of the first `n` entities of the request's list."""

    def __init__(self, n: int = 2):
        self.n = n
        self.requests = []

    def chat_text(self, model, messages, **kw):
        import ast

        content = messages[-1]["content"]
        self.requests.append(content)
        entities = ast.literal_eval(content.split("<List>")[1])
        return "\n".join(f"thing {i} - {e}"
                         for i, e in enumerate(entities[:self.n]))
