"""Model initialization with random weights.

Counterpart of video_llava_tpu/runtime/model_init.py::initialize_model
for the random-weight path: the configuration by size, video special
token ids from the tokenizer, and weights drawn on the device from a
seeded ``torch.Generator`` with the JAX package's init scales. Loading
checkpoints, quantization and meshes are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from video_llava_tpu.config import (
    CLIPVisionConfig,
    GenerationConfig,
    LlamaConfig,
    VideoLLaVAConfig,
)
from video_llava_tpu.runtime.tokenizer import load_tokenizer
from video_llava_tpu_torch.models.video_llava import VideoLLaVA
from video_llava_tpu_torch.runtime.inference import InferenceEngine


def model_config(model_size: str, image_size: int = 224) -> VideoLLaVAConfig:
    if model_size == "tiny":
        return VideoLLaVAConfig.tiny()
    llms = {"7b": LlamaConfig.vicuna_7b, "13b": LlamaConfig.vicuna_13b}
    if model_size not in llms:
        raise ValueError(f"model_size: one of tiny, 7b, 13b; got {model_size}")
    return VideoLLaVAConfig(llm=llms[model_size](),
                            vision=CLIPVisionConfig(image_size=image_size))


@torch.no_grad()
def random_init_(model: torch.nn.Module, generator: torch.Generator) -> None:
    """Fill every parameter as the JAX package's initializers do: linear
    kernels (and the patch embedding) N(0, 1/in_dim), embedding tables
    N(0, 0.02^2), biases 0, norm scales 1."""
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "bias":
            p.zero_()
        elif leaf == "scale":
            p.fill_(1.0)
        elif leaf in ("kernel", "patch_embedding"):
            p.normal_(0.0, p.shape[0] ** -0.5, generator=generator)
        else:  # embed_tokens.weight, class/position embeddings
            p.normal_(0.0, 0.02, generator=generator)


def initialize_model(
    model_name: Optional[str] = None,
    model_size: str = "7b",
    device="cuda",
    seed: int = 0,
    dtype: torch.dtype = torch.bfloat16,
    image_size: int = 224,
) -> InferenceEngine:
    """Build an InferenceEngine with random weights made on `device`.
    model_name (a checkpoint directory) is not supported yet; the
    tokenizer is the byte-level fallback."""
    if model_name is not None:
        raise NotImplementedError("checkpoint loading is not ported yet")
    tokenizer = load_tokenizer(None)
    cfg = dataclasses.replace(
        model_config(model_size, image_size),
        vid_patch_token_id=tokenizer.vid_patch_token_id,
        vid_start_token_id=tokenizer.vid_start_token_id,
        vid_end_token_id=tokenizer.vid_end_token_id,
    )
    device = torch.device(device)
    model = VideoLLaVA(cfg, device=device, dtype=dtype)
    generator = torch.Generator(device=device).manual_seed(seed)
    random_init_(model, generator)
    return InferenceEngine(
        model=model, cfg=cfg, tokenizer=tokenizer,
        gen=GenerationConfig(eos_token_id=tokenizer.eos_token_id,
                             pad_token_id=tokenizer.pad_token_id),
    )
