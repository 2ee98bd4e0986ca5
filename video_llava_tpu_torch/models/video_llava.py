"""VideoLLaVA: CLIP vision tower + mm_projector + Vicuna LM.

Counterpart of video_llava_tpu/models/video_llava.py for inference:
video encode (CLIP penultimate patches + spatio-temporal pooling), the
vectorized splice of projected video features into the token
embeddings, and prefill of a right-padded batch into a fresh KV cache.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from video_llava_tpu_torch.config import VideoLLaVAConfig
from video_llava_tpu_torch.models.clip import CLIPVisionTower
from video_llava_tpu_torch.models.llama import KVCache, Llama
from video_llava_tpu_torch.models.projector import Projector
from video_llava_tpu_torch.ops.pooling import spatio_temporal_pool_fused


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


class VideoLLaVA(nn.Module):
    """llm_quant (None, "int8", "int4"), group_size and llm_fuse set the
    LLM's layout (models/llama.py); CLIP and the projector stay in
    `dtype`."""

    def __init__(self, cfg: VideoLLaVAConfig, *, device=None,
                 dtype=torch.bfloat16, llm_quant: Optional[str] = None,
                 group_size: Optional[int] = 128, llm_fuse: bool = False):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.vision = CLIPVisionTower(cfg.vision, **kw)
        self.projector = Projector(cfg.projector, **kw)
        self.llm = Llama(cfg.llm, quant=llm_quant, group_size=group_size,
                         fuse=llm_fuse, **kw)

    def encode_video(self, pixels: torch.Tensor,
                     num_valid_frames: Optional[int] = None) -> torch.Tensor:
        """(t, H, W, 3) normalized frames -> pooled features
        (video_token_len, mm_hidden) in the tower's dtype."""
        feats = self.vision.encode_frames(pixels)
        return spatio_temporal_pool_fused(
            feats, num_valid_frames=num_valid_frames,
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
        cache = KVCache.create(self.cfg.llm, b, max_cache_len, cache_dtype,
                               device)
        embeds = self.build_inputs_embeds(input_ids, video_features)
        positions = torch.arange(s, dtype=torch.int32,
                                 device=device)[None].expand(b, s)
        hidden, cache = self.llm.forward_hidden(embeds, positions, cache,
                                                new_length=seq_lens)
        last = hidden[torch.arange(b, device=device), seq_lens.long() - 1]
        return PrefillResult(self.llm.logits(last), cache)
