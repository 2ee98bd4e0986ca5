"""Assembly of the grounding stack: detector, SAM (MobileSAM or ViT-B),
the CLIP crop filter, the STM or XMem tracker, the tagger (a linear head
or RAM's decoder) and entity matching.

Counterpart of video_llava_tpu/grounding/builders.py. Each model reads
its released checkpoint (GroundingDINO's .pth or HF directory, SAM's HF
directory or MobileSAM's mobile_sam.pt, an HF Swin or the RAM release,
an HF CLIP directory, XMem's .pth) or, without one, draws random weights
on `device` from a seeded torch.Generator, in the JAX package's layout.
Every builder puts its model on the card unless the caller asks for the
CPU.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
import zlib
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from video_llava_tpu_torch.config import CLIPTextConfig, CLIPVisionConfig
from video_llava_tpu_torch.grounding.clip_filter import ClipCropFilter
from video_llava_tpu_torch.grounding.entity_matching import (
    EntityMatchingModule,
)
from video_llava_tpu_torch.grounding.memory_tracker import (
    LearnedMemoryTracker,
    TrackerConfig,
)
from video_llava_tpu_torch.grounding.tagging import (
    TaggingModule,
    init_tag_head,
)
from video_llava_tpu_torch.grounding.tracker import GroundedTracker
from video_llava_tpu_torch.models import clip as clip_mod
from video_llava_tpu_torch.models import sam as sam_mod
from video_llava_tpu_torch.models import swin as swin_mod
from video_llava_tpu_torch.models import tiny_vit as tv
from video_llava_tpu_torch.models import xmem as xmem_mod
from video_llava_tpu_torch.models.layers import TreeInit
from video_llava_tpu_torch.models.sam import SamConfig
from video_llava_tpu_torch.models.swin import SwinConfig
from video_llava_tpu_torch.ops.image import normalize_clip, resize_bicubic

DEFAULT_TAG_LIST = [
    "person", "man", "woman", "child", "dog", "cat", "car", "bicycle",
    "tree", "building", "table", "chair", "food", "water", "road",
    "grass", "sky", "ball", "phone", "guitar",
]


class SamSegmenter:
    """segmenter(image, boxes) -> (n, H, W) masks, best of the three
    multimask outputs by predicted IoU. The image encoder and the prompt
    + mask decoder run apart, so detection frames encode in batches
    (precompute_embeddings) and per-frame calls only decode."""

    supports_frame_cache = True

    def __init__(self, params, cfg: SamConfig, encode_fn=None,
                 encode_batch_size: int = 4):
        """encode_fn(params, pixels) -> (b, g, g, d) image embeddings:
        SAM's ViT encoder (params['vision']) by default, MobileSAM's
        TinyViT encoder where build_sam passes it."""
        self.params = params
        self.cfg = cfg
        self.encode_batch_size = encode_batch_size
        self._encode = encode_fn or (
            lambda p, px: sam_mod.vision_encoder(p["vision"], px, cfg.vision))
        self.device = params["shared_pe"].device
        self._emb_cache: dict = {}

    def _encode_raw(self, raw: torch.Tensor) -> torch.Tensor:
        """(k, H, W, 3) uint8 -> embeddings: cast, bicubic resize, round,
        normalize and encode on the device."""
        size = self.cfg.vision.image_size
        x = resize_bicubic(raw.to(self.device).float(), size, size)
        x = normalize_clip(torch.clamp(torch.round(x), 0, 255)).to(
            self.params["shared_pe"].dtype)
        return self._encode(self.params, x)

    @torch.inference_mode()
    def precompute_embeddings(self, frames, frame_indices,
                              batch_size: Optional[int] = None) -> None:
        """Encode frames[i] for i in frame_indices in fixed-size batches
        (the last pads by repetition) into the per-frame cache."""
        k = batch_size or self.encode_batch_size
        idx = [i for i in frame_indices if i not in self._emb_cache]
        for start in range(0, len(idx), k):
            chunk = idx[start:start + k]
            padded = chunk + [chunk[-1]] * (k - len(chunk))
            raw = torch.as_tensor(np.stack([np.asarray(frames[i])
                                            for i in padded]))
            emb = self._encode_raw(raw)
            for j, i in enumerate(chunk):
                self._emb_cache[i] = emb[j:j + 1]

    @torch.inference_mode()
    def decode_masks_batch_device(self, frames, boxes: np.ndarray,
                                  out_hw: Optional[Tuple[int, int]] = None):
        """Batched box -> mask decode that stays on the device (the
        whole-clip tracker's producer). frames (F, H, W, 3) uint8 (numpy
        or a tensor), boxes (F, K, 4) xyxy pixels -> (F, K, Hp, Wp) uint8
        {0, 1}, (Hp, Wp) = out_hw or (H, W), zero-padded bottom/right:
        best-IoU head, > 0, nearest upsample from the mask grid."""
        frames = (frames if isinstance(frames, torch.Tensor)
                  else torch.as_tensor(np.asarray(frames))).to(self.device)
        f_count, H, W = frames.shape[:3]
        hp, wp = out_hw or (H, W)
        size = self.cfg.vision.image_size
        k = self.encode_batch_size
        embs = []
        for s in range(0, f_count, k):
            chunk = frames[s:s + k]
            n = len(chunk)
            if n < k:
                chunk = torch.cat([chunk, chunk[-1:].expand(
                    (k - n,) + chunk.shape[1:])])
            embs.append(self._encode_raw(chunk)[:n])
        emb = torch.cat(embs)
        scale = torch.tensor([size / W, size / H, size / W, size / H])
        scaled = (torch.as_tensor(np.asarray(boxes, np.float32))
                  * scale).to(self.device)
        outs = []
        for s in range(0, f_count, 4):  # bounds the box-repeated embedding
            masks, iou = sam_mod.predict_from_embeddings(
                self.params, emb[s:s + 4], scaled[s:s + 4], self.cfg)
            best = iou.argmax(dim=-1)  # (F, K)
            m = torch.gather(masks, 2, best[:, :, None, None, None].expand(
                masks.shape[:2] + (1,) + masks.shape[3:]))[:, :, 0]
            g = m.shape[-1]
            ys = (torch.arange(H, device=self.device) * g // H).clamp(0, g - 1)
            xs = (torch.arange(W, device=self.device) * g // W).clamp(0, g - 1)
            up = (m[:, :, ys][:, :, :, xs] > 0).to(torch.uint8)
            outs.append(torch.nn.functional.pad(up, (0, wp - W, 0, hp - H)))
        return torch.cat(outs)

    def num_cached_embeddings(self) -> int:
        return len(self._emb_cache)

    def discard_embedding(self, frame_index) -> None:
        self._emb_cache.pop(frame_index, None)

    def clear_cache(self) -> None:
        self._emb_cache = {}

    @torch.inference_mode()
    def __call__(self, image: np.ndarray, boxes: np.ndarray,
                 frame_index: Optional[int] = None) -> np.ndarray:
        H, W = image.shape[:2]
        size = self.cfg.vision.image_size
        emb = (self._emb_cache.pop(frame_index, None)
               if frame_index is not None else None)
        if emb is None:
            emb = self._encode_raw(torch.as_tensor(np.asarray(image))[None])
        scaled = boxes.astype(np.float32) * np.array(
            [size / W, size / H, size / W, size / H], np.float32)
        n = len(scaled)
        masks, iou = sam_mod.predict_from_embeddings(
            self.params, emb, torch.as_tensor(scaled, device=self.device)[None],
            self.cfg)
        masks, iou = masks[0].cpu().numpy(), iou[0].cpu().numpy()
        best = iou.argmax(axis=1)
        out = np.zeros((n, H, W), np.float32)
        for i, b in enumerate(best):
            m = masks[i, b] > 0
            g = m.shape[0]
            ys = (np.arange(H) * g // H).clip(0, g - 1)
            xs = (np.arange(W) * g // W).clip(0, g - 1)
            out[i] = m[np.ix_(ys, xs)].astype(np.float32)
        return out


def _load_state_dict(path: str):
    """A checkpoint file (.pth / .pt / .bin, with its training nesting
    unwrapped) or an HF directory's whole state dict."""
    from video_llava_tpu_torch.engine.weights import (
        load_checkpoint_dir,
        load_torch_checkpoint_file,
    )

    return (load_torch_checkpoint_file(path) if os.path.isfile(path)
            else load_checkpoint_dir(path))


def build_sam(checkpoint_dir: Optional[str] = None,
              cfg: Optional[SamConfig] = None, variant: str = "mobile",
              tiny_cfg: Optional[tv.TinyViTConfig] = None, device="cuda",
              seed: int = 0) -> SamSegmenter:
    """The segmenter on `device`, as the JAX package's build_sam:
    variant 'mobile' (the reference's live default): TinyViT-5M + SAM's
    prompt encoder and mask decoder, from the official mobile_sam.pt
    (image_encoder.*, prompt_encoder.*, mask_decoder.*) or a directory of
    its shards; 'vit_b' (or 'vit'): SAM's ViT encoder from an HF SamModel
    directory or file (facebook/sam-vit-base layout; cfg defaults to
    ViT-B at 1024 px). Without a checkpoint, random weights drawn on
    `device` from `seed`."""
    if variant == "mobile":
        tiny_cfg = tiny_cfg or tv.TinyViTConfig()
        cfg = cfg or SamConfig(vision=dataclasses.replace(
            SamConfig().vision, image_size=tiny_cfg.image_size))
        if checkpoint_dir:
            sd = _load_state_dict(checkpoint_dir)
            params = {"vision": tv.convert_tiny_vit(sd, tiny_cfg,
                                                    device=device),
                      **sam_mod.convert_official_sam_decoder(sd, cfg, device)}
        else:
            warnings.warn("MobileSAM weights not provided; using random init")
            init = TreeInit(seed, device)
            params = {"vision": tv.init_params(init, tiny_cfg),
                      **sam_mod.init_decoder_params(init, cfg)}
        return SamSegmenter(
            params, cfg, lambda p, px: tv.encoder(p["vision"], px, tiny_cfg))
    if variant not in ("vit_b", "vit"):
        raise ValueError(f"SAM variant {variant!r}: 'mobile' or 'vit_b'")
    cfg = cfg or SamConfig()
    if checkpoint_dir:
        params = sam_mod.convert_hf_sam(_load_state_dict(checkpoint_dir), cfg,
                                        device)
    else:
        warnings.warn("SAM weights not provided; using random init")
        init = TreeInit(seed, device)
        params = {"vision": sam_mod.init_vision_params(init, cfg.vision),
                  **sam_mod.init_decoder_params(init, cfg)}
    return SamSegmenter(params, cfg)


def build_tagger(swin_checkpoint: Optional[str] = None,
                 tag_list: Sequence[str] = DEFAULT_TAG_LIST,
                 cfg: Optional[SwinConfig] = None,
                 ram_checkpoint: Optional[str] = None,
                 tag_list_path: Optional[str] = None,
                 threshold_path: Optional[str] = None, device="cuda",
                 seed: int = 0) -> TaggingModule:
    """The tagger on `device`, as the JAX package's build_tagger.
    ram_checkpoint: a released RAM state dict (ram_swin_large_14m.pth
    layout, a file or a directory): the timm Swin-L backbone, the q2l
    decoder and the per-tag thresholds (models/ram.py), with the tags of
    tag_list_path (ram_tag_list.txt) and, when given, the thresholds of
    threshold_path; the tag count must be the checkpoint's. The Swin
    window is read from the checkpoint's relative-position tables (the
    release's Swin-L at 384 px uses 12, SwinConfig.swin_l() 7). Else a
    Swin backbone from an HF SwinModel directory (swin_checkpoint) or
    random, with a random linear tag head over tag_list, drawn on
    `device` from `seed`."""
    cfg = cfg or SwinConfig.swin_l()
    if ram_checkpoint:
        from video_llava_tpu_torch.models import ram as ram_mod

        sd = {k.removeprefix("module."): v
              for k, v in _load_state_dict(ram_checkpoint).items()}
        window = swin_mod.timm_window_size(sd, "visual_encoder.")
        if window is not None and window != cfg.window_size:
            cfg = dataclasses.replace(cfg, window_size=window)
        ram_cfg = ram_mod.infer_ram_config(sd)
        backbone, ram_params, thresholds = ram_mod.convert_ram_checkpoint(
            sd, cfg, ram_cfg, device)
        tags = (ram_mod.load_tag_list(tag_list_path) if tag_list_path
                else list(tag_list))
        if len(tags) != ram_cfg.num_tags:
            raise ValueError(
                f"tag list has {len(tags)} entries but the checkpoint "
                f"predicts {ram_cfg.num_tags} tags: pass the release's "
                "ram_tag_list.txt as tag_list_path")
        if threshold_path:
            thresholds = ram_mod.load_tag_thresholds(threshold_path,
                                                     len(tags))
        return TaggingModule.with_ram_decoder(backbone, ram_params, cfg,
                                              ram_cfg, tags,
                                              threshold=thresholds)
    init = TreeInit(seed, device)
    if swin_checkpoint:
        backbone = swin_mod.convert_hf_swin(_load_state_dict(swin_checkpoint),
                                            cfg, device)
    else:
        backbone = swin_mod.init_params(init, cfg)
    head = init_tag_head(init, cfg.num_features, len(tag_list))
    return TaggingModule(backbone, head, cfg, tag_list)


def random_clip_filter(seed: int = 0, dtype=torch.float32,
                       prob_threshold: float = 0.1,
                       score_threshold: float = 0.2,
                       device="cuda") -> ClipCropFilter:
    """A random ViT-B/32 crop filter on `device` (the card unless the
    caller asks for the CPU) with a deterministic hash tokenizer: not for
    quality (random towers score noise) but the real filter's compute
    shape, for benches and tests. The weights are drawn by a CPU
    generator from `seed` and then moved, so a seed gives the same
    filter on every device. The tokenizer: a word's crc32 modulo
    vocab_size - 2, plus 1, then EOT = the largest id, where
    text_forward's argmax pooling finds it."""
    vcfg, tcfg = CLIPVisionConfig.b32(), CLIPTextConfig.b32()
    draw_on = "meta" if torch.device(device).type == "meta" else "cpu"
    init = TreeInit(seed, draw_on, dtype)
    tower = clip_mod.CLIPVisionTower(vcfg, device=draw_on, dtype=dtype)
    tower.requires_grad_(False)
    for name, p in tower.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "bias":
            p.zero_()
        elif leaf == "scale":
            p.fill_(1.0)
        else:  # kernels N(0, 1/in); class and position embeddings 0.02
            p.copy_(init.normal(p.shape, p.shape[0] ** -0.5
                                if leaf in ("kernel", "patch_embedding")
                                else 0.02))
    text = _tree_to(clip_mod.init_text_params(init, tcfg), device)
    proj = init.normal((vcfg.hidden_size, vcfg.projection_dim),
                       vcfg.hidden_size ** -0.5).to(device)
    tower.to(device)

    def tokenize(s: str):
        ids = [zlib.crc32(w.encode()) % (tcfg.vocab_size - 2) + 1
               for w in s.split()]
        return ids[:tcfg.max_position_embeddings - 1] + [tcfg.vocab_size - 1]

    return ClipCropFilter(tower, text, tcfg, tokenize,
                          visual_projection={"kernel": proj},
                          prob_threshold=prob_threshold,
                          score_threshold=score_threshold)


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


def _check_clip_shapes(sd, vcfg: CLIPVisionConfig,
                       tcfg: CLIPTextConfig) -> None:
    """Raise unless the checkpoint's towers have the configs' sizes."""
    v, t = vcfg.hidden_size, tcfg.hidden_size
    want = {
        "vision_model.embeddings.patch_embedding.weight":
            (v, 3, vcfg.patch_size, vcfg.patch_size),
        "vision_model.embeddings.position_embedding.weight":
            (vcfg.num_positions, v),
        "vision_model.encoder.layers.0.mlp.fc1.weight":
            (vcfg.intermediate_size, v),
        "text_model.embeddings.token_embedding.weight":
            (tcfg.vocab_size, t),
        "text_model.embeddings.position_embedding.weight":
            (tcfg.max_position_embeddings, t),
        "text_model.encoder.layers.0.mlp.fc1.weight":
            (tcfg.intermediate_size, t),
        "visual_projection.weight": (vcfg.projection_dim, v),
        "text_projection.weight": (tcfg.projection_dim, t),
    }
    for i, cfg, tower in ((vcfg.num_layers - 1, vcfg, "vision_model"),
                          (tcfg.num_layers - 1, tcfg, "text_model")):
        want[f"{tower}.encoder.layers.{i}.layer_norm1.weight"] = (
            cfg.hidden_size,)
    for key, shape in want.items():
        have = tuple(sd[key].shape) if key in sd else None
        if have != shape:
            raise ValueError(
                f"CLIP checkpoint {key}: {have} where the crop filter's "
                f"configs (vision {vcfg}, text {tcfg}) give {shape}; "
                "build_clip_filter builds the default (ViT-L/14) towers, "
                "as the JAX package's does")


def build_clip_filter(clip_checkpoint: Optional[str] = None,
                      device="cuda") -> Optional[ClipCropFilter]:
    """The CLIP zero-shot crop filter from an HF CLIPModel directory
    (weights, and vocab.json + merges.txt or tokenizer.json), on `device`;
    None without a directory (random towers would score noise). As the
    JAX package's build_clip_filter, the towers take the default
    CLIPVisionConfig / CLIPTextConfig (ViT-L/14), whatever the checkpoint
    holds; a checkpoint of other sizes raises (_check_clip_shapes)."""
    if not clip_checkpoint:
        return None
    from video_llava_tpu_torch.engine.weights import (
        convert_clip_text,
        convert_clip_vision,
        load_checkpoint_dir,
    )
    from video_llava_tpu_torch.runtime.tokenizer import CLIPTokenizer

    sd = load_checkpoint_dir(clip_checkpoint)
    vcfg, tcfg = CLIPVisionConfig(), CLIPTextConfig()
    _check_clip_shapes(sd, vcfg, tcfg)
    tower = clip_mod.CLIPVisionTower(vcfg, device=device)
    tower.requires_grad_(False)
    convert_clip_vision(sd, tower)
    text = convert_clip_text(sd, tcfg, device=device)
    proj = sd["visual_projection.weight"].to(device=device,
                                             dtype=torch.float32)
    tok = CLIPTokenizer(clip_checkpoint)
    return ClipCropFilter(tower, text, tcfg, tokenize=tok.encode,
                          visual_projection={"kernel": proj.T.contiguous()})


def build_xmem_propagator(xmem_checkpoint: str, max_objects: int,
                          device="cuda") -> Optional[LearnedMemoryTracker]:
    """LearnedMemoryTracker from an XMem/DEVA-propagation .pth (its
    'network' nesting unwrapped), or None with a warning when the file is
    missing (the caller keeps the handcrafted STM)."""
    from video_llava_tpu_torch.engine.weights import (
        load_torch_checkpoint_file,
    )

    if not os.path.isfile(xmem_checkpoint):
        warnings.warn(f"xmem checkpoint {xmem_checkpoint} not found; using "
                      "handcrafted-feature propagation")
        return None
    sd = load_torch_checkpoint_file(xmem_checkpoint)
    cfg = xmem_mod.XMemConfig(max_objects=max_objects)
    return LearnedMemoryTracker(
        xmem_mod.convert_xmem_checkpoint(sd, cfg, device=device), cfg)


def build_grounding_stack(
    dino_checkpoint: Optional[str] = None,
    sam_checkpoint: Optional[str] = None,
    swin_checkpoint: Optional[str] = None,
    clip_checkpoint: Optional[str] = None,
    xmem_checkpoint: Optional[str] = None,
    detection_every: int = 5,
    temporal_setting: str = "online",
    max_objects: int = 5,
    sam_variant: str = "mobile",
    device="cuda",
    seed: int = 0,
    tokenizer_name: str = "bert-base-uncased",
):
    """The PGVideoLLaVA grounding stack (reference chat.py:243-252):
    GroundingDINO Swin-T at 800 px (dino_checkpoint: an original-repo
    .pth, read with the BERT vocabulary directory tokenizer_name, or an
    HF directory), SAM (sam_variant 'mobile': MobileSAM, sam_checkpoint
    its mobile_sam.pt; 'vit_b': SAM ViT-B, an HF SamModel directory), the
    CLIP crop filter when clip_checkpoint names an HF CLIP directory, the
    XMem propagator when xmem_checkpoint names its .pth (else the
    handcrafted STM, with a warning when the file is missing), a Swin-L
    tagger (swin_checkpoint: an HF Swin directory), entity matching; all
    on `device` (the card unless the caller asks for the CPU), a model
    without its checkpoint with random weights from `seed`."""
    from video_llava_tpu_torch.models import grounding_dino as gdino_mod

    detector = gdino_mod.build_detector(dino_checkpoint,
                                        tokenizer_name=tokenizer_name,
                                        device=device, seed=seed)
    segmenter = build_sam(sam_checkpoint, variant=sam_variant, device=device,
                          seed=seed + 1)
    crop_filter = build_clip_filter(clip_checkpoint, device=device)
    propagator = (build_xmem_propagator(xmem_checkpoint, max_objects, device)
                  if xmem_checkpoint else None)
    tracker = GroundedTracker(
        detector=detector, segmenter=segmenter, crop_filter=crop_filter,
        detection_every=detection_every, temporal_setting=temporal_setting,
        tracker_cfg=TrackerConfig(max_objects=max_objects),
        propagator=propagator, device=device)
    tagger = build_tagger(swin_checkpoint, device=device, seed=seed + 2)
    return tracker, tagger, EntityMatchingModule()
