"""The model and generation configurations.

The same dataclasses, fields and defaults as video_llava_tpu/config.py,
so that one configuration names the same model in both packages
(tests/test_torch_config_parity.py holds them equal). Only what the port
runs is here: no mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    """CLIP ViT-L/14 vision tower: 224 px -> 16x16 = 256 patches,
    336 px -> 24x24 = 576 patches, hidden 1024."""

    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"
    projection_dim: int = 768

    @property
    def grid_size(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size * self.grid_size

    @property
    def num_positions(self) -> int:
        return self.num_patches + 1  # + CLS

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @classmethod
    def b32(cls) -> "CLIPVisionConfig":
        """OpenAI CLIP ViT-B/32: the grounding crop filter's tower
        (reference clip.load('ViT-B/32'), grounding_new_api.py:295)."""
        return cls(image_size=224, patch_size=32, hidden_size=768,
                   intermediate_size=3072, num_layers=12, num_heads=12,
                   projection_dim=512)


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    """CLIP text tower (ViT-L/14's by default): the grounding crop
    filter's zero-shot class embeddings."""

    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"
    projection_dim: int = 768

    @classmethod
    def b32(cls) -> "CLIPTextConfig":
        """ViT-B/32's text tower."""
        return cls(hidden_size=512, intermediate_size=2048, num_layers=12,
                   num_heads=8, projection_dim=512)


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """LLaMA / Vicuna decoder, Vicuna-7B by default. vocab_size counts
    the 3 added video tokens (32000..32002), padded up to 32006."""

    vocab_size: int = 32006
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: int = 128
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0

    @classmethod
    def vicuna_7b(cls) -> "LlamaConfig":
        return cls()

    @classmethod
    def vicuna_13b(cls) -> "LlamaConfig":
        return cls(hidden_size=5120, intermediate_size=13824, num_layers=40,
                   num_heads=40, num_kv_heads=40)

    @classmethod
    def tiny(cls, vocab_size: int = 32006) -> "LlamaConfig":
        """Structurally complete but small; for tests and dry runs."""
        return cls(vocab_size=vocab_size, hidden_size=256,
                   intermediate_size=688, num_layers=4, num_heads=8,
                   num_kv_heads=8, head_dim=32, max_position_embeddings=2048)


@dataclasses.dataclass(frozen=True)
class ProjectorConfig:
    """mm_projector: 'linear', 'mlp{N}x_gelu' or 'identity'."""

    projector_type: str = "linear"
    mm_hidden_size: int = 1024
    hidden_size: int = 4096


@dataclasses.dataclass(frozen=True)
class VideoLLaVAConfig:
    """Vision tower + projector + LM. video_token_len = patches per
    frame + max_temporal_tokens."""

    vision: CLIPVisionConfig = dataclasses.field(
        default_factory=CLIPVisionConfig)
    llm: LlamaConfig = dataclasses.field(default_factory=LlamaConfig)
    projector_type: str = "linear"
    use_vid_start_end: bool = True
    max_temporal_tokens: int = 100
    vid_patch_token_id: int = 32000
    vid_start_token_id: int = 32001
    vid_end_token_id: int = 32002

    @property
    def video_token_len(self) -> int:
        return self.vision.num_patches + self.max_temporal_tokens

    @property
    def projector(self) -> ProjectorConfig:
        return ProjectorConfig(projector_type=self.projector_type,
                               mm_hidden_size=self.vision.hidden_size,
                               hidden_size=self.llm.hidden_size)

    @classmethod
    def tiny(cls) -> "VideoLLaVAConfig":
        """Small end-to-end config for tests and dry runs."""
        vision = CLIPVisionConfig(image_size=56, patch_size=14, hidden_size=64,
                                  intermediate_size=256, num_layers=2,
                                  num_heads=4, projection_dim=64)
        return cls(vision=vision, llm=LlamaConfig.tiny(),
                   max_temporal_tokens=100)


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    """Sampling parameters (the reference's defaults: sampling at
    temperature 0.2, up to 1024 new tokens)."""

    max_new_tokens: int = 1024
    temperature: float = 0.2
    do_sample: bool = True
    top_p: float = 1.0
    eos_token_id: int = 2
    pad_token_id: int = 0
    # Token ids that end generation at once (keyword stop).
    stop_token_ids: Tuple[int, ...] = ()
    # Decoded-substring stop strings, checked on the host in chunks.
    stop_strings: Tuple[str, ...] = ()
