"""VideoLLaVA: CLIP vision tower + mm_projector + Vicuna LM.

Counterpart of video_llava_tpu/models/video_llava.py: video encode
(CLIP penultimate patches + spatio-temporal pooling), the vectorized
splice of projected video features into the token embeddings (a gather
and a where, so the projector and embed_tokens take gradients through
it), prefill of a right-padded batch into a fresh KV cache, and the
training forward without a cache with its shifted cross-entropy.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from video_llava_tpu_torch.config import VideoLLaVAConfig
from video_llava_tpu_torch.constants import IGNORE_INDEX
from video_llava_tpu_torch.models.clip import CLIPVisionTower
from video_llava_tpu_torch.models.llama import KVCache, Llama
from video_llava_tpu_torch.models.projector import Projector
from video_llava_tpu_torch.ops.pooling import (
    get_pooling_mesh,
    spatio_temporal_pool_fused,
    spatio_temporal_pool_sharded,
)


class PrefillResult(NamedTuple):
    logits_last: torch.Tensor  # (b, vocab) f32 at each row's last token
    cache: KVCache


def splice_video_embeddings(token_embeds, input_ids, video_features,
                            vid_patch_token_id: int):
    """Replace embeddings at <vid_patch> positions: the j-th patch token
    of each row takes video_features[:, j]. token_embeds (b, s, d),
    input_ids (b, s), video_features (b, n, d)."""
    mask = input_ids == vid_patch_token_id
    n = video_features.shape[1]
    order = (torch.cumsum(mask.int(), dim=1) - 1).clamp(0, n - 1)
    gathered = torch.gather(
        video_features, 1,
        order.long()[:, :, None].expand(-1, -1, video_features.shape[-1]),
    )
    return torch.where(mask[:, :, None], gathered.to(token_embeds.dtype),
                       token_embeds)


def shifted_log_likelihood(logits: torch.Tensor, labels: torch.Tensor):
    """(the summed f32 log-probability of labels[:, 1:] under
    logits[:, :-1] over the targets that are not IGNORE_INDEX, their
    int count): the parts of :func:`shifted_cross_entropy`, which a
    data-parallel step sums over its ranks before it divides."""
    shift_labels = labels[:, 1:].long()
    valid = shift_labels != IGNORE_INDEX
    safe = torch.where(valid, shift_labels, torch.zeros_like(shift_labels))
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    token_logp = torch.gather(logp, -1, safe[..., None])[..., 0]
    return torch.where(valid, token_logp, 0.0).sum(), valid.sum()


def shifted_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Mean CE of logits[:, :-1] against labels[:, 1:] over the targets
    that are not IGNORE_INDEX, with an f32 log-softmax (JAX
    models/video_llava.py:160-169)."""
    logp_sum, n = shifted_log_likelihood(logits, labels)
    return -logp_sum / n.clamp_min(1)


class VideoLLaVA(nn.Module):
    """llm_quant (None, "int8", "int4"), group_size, llm_fuse and
    llm_skip_keys (leaves kept dense beside the default ones) set the
    LLM's layout (models/llama.py); CLIP and the projector stay in
    `dtype`. `mesh` is the tensor-parallel mesh once
    parallel/sharding.shard_params has kept this rank's shard (JAX
    models/video_llava.py:185-200 takes it as an argument): prefill
    builds its cache at the local head count."""

    mesh = None

    def __init__(self, cfg: VideoLLaVAConfig, *, device=None,
                 dtype=torch.bfloat16, llm_quant: Optional[str] = None,
                 group_size: Optional[int] = 128, llm_fuse: bool = False,
                 llm_skip_keys: Tuple[str, ...] = ()):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.vision = CLIPVisionTower(cfg.vision, **kw)
        self.projector = Projector(cfg.projector, **kw)
        self.llm = Llama(cfg.llm, quant=llm_quant, group_size=group_size,
                         fuse=llm_fuse, skip_keys=llm_skip_keys, **kw)

    def encode_video(self, pixels: torch.Tensor,
                     num_valid_frames: Optional[int] = None,
                     frame_batch: int = 0) -> torch.Tensor:
        """(t, H, W, 3) normalized frames -> pooled features
        (video_token_len, mm_hidden) in the tower's dtype; frame_batch
        as in CLIPVisionTower.encode_frames. Under a registered pooling
        mesh (ops/pooling.set_pooling_mesh) the pooling is frame-sharded
        over its 'data' axis, as the JAX package's encode_video does
        (a (1, m) mesh's one data shard included)."""
        feats = self.vision.encode_frames(pixels, frame_batch)
        mesh = get_pooling_mesh()
        if mesh is not None:
            return spatio_temporal_pool_sharded(
                feats, num_valid_frames, mesh,
                max_temporal_tokens=self.cfg.max_temporal_tokens,
                out_dtype=feats.dtype)
        return spatio_temporal_pool_fused(
            feats, num_valid_frames=num_valid_frames,
            max_temporal_tokens=self.cfg.max_temporal_tokens,
            out_dtype=feats.dtype,
        )

    def encode_videos(self, pixels: torch.Tensor,
                      num_valid_frames: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
        """A batch of videos: (b, t, H, W, 3) normalized frames and (b,)
        int32 valid counts on their device -> pooled features (b,
        video_token_len, mm_hidden), what :meth:`encode_video` gives each
        video (the JAX package vmaps encode_video over the batch). CLIP
        runs once over all b*t frames; the pooling kernel takes every
        video in one launch."""
        b, t = pixels.shape[:2]
        feats = self.vision.encode_frames(pixels.reshape(b * t,
                                                         *pixels.shape[2:]))
        return spatio_temporal_pool_fused(
            feats.reshape(b, t, *feats.shape[1:]),
            num_valid_frames=num_valid_frames,
            max_temporal_tokens=self.cfg.max_temporal_tokens,
            out_dtype=feats.dtype,
        )

    def build_inputs_embeds(self, input_ids: torch.Tensor,
                            video_features: Optional[torch.Tensor]):
        """Token embeddings with projected video features spliced in;
        video_features: raw pooled features (b, video_token_len, c)."""
        embeds = self.llm.embed_tokens(input_ids)
        if video_features is not None:
            embeds = splice_video_embeddings(
                embeds, input_ids, self.projector(video_features),
                self.cfg.vid_patch_token_id,
            )
        return embeds

    def prefill(self, input_ids: torch.Tensor, seq_lens: torch.Tensor,
                video_features: Optional[torch.Tensor], max_cache_len: int,
                cache_dtype=torch.bfloat16) -> PrefillResult:
        """Prefill a right-padded batch (b, s_pad) with real lengths
        seq_lens (b,) into a fresh cache; logits at position
        seq_lens - 1 of each row, cache.length = seq_lens."""
        b, s = input_ids.shape
        device = input_ids.device
        seq_lens = seq_lens.to(device=device, dtype=torch.int32)
        # the LLM's own configuration: under a mesh, the local heads
        cache = KVCache.create(self.llm.cfg, b, max_cache_len, cache_dtype,
                               device)
        embeds = self.build_inputs_embeds(input_ids, video_features)
        positions = torch.arange(s, dtype=torch.int32,
                                 device=device)[None].expand(b, s)
        hidden, cache = self.llm.forward_hidden(embeds, positions, cache,
                                                new_length=seq_lens)
        last = hidden[torch.arange(b, device=device), seq_lens.long() - 1]
        return PrefillResult(self.llm.logits(last), cache)

    def forward(self, input_ids: torch.Tensor,
                video_features: Optional[torch.Tensor] = None,
                labels: Optional[torch.Tensor] = None,
                remat: bool = False):
        """The multimodal LM forward without a cache -> (logits (b, s,
        vocab) f32, loss or None): the shifted masked cross-entropy of
        `labels` (JAX forward with cache=None, :133-157). remat=True
        recomputes each decoder layer in the backward pass."""
        embeds = self.build_inputs_embeds(input_ids, video_features)
        logits, _ = self.llm.forward(inputs_embeds=embeds, remat=remat)
        loss = None if labels is None else shifted_cross_entropy(logits,
                                                                 labels)
        return logits, loss
