"""Model initialization with random weights.

Counterpart of video_llava_tpu/runtime/model_init.py::initialize_model
for the random-weight path: the configuration by size, video special
token ids from the tokenizer, and weights drawn on the device from a
seeded ``torch.Generator`` with the JAX package's init scales. With
``llm_quant`` the LLM's weights are drawn in bf16 one layer at a time
and quantized on the device with the port's quantize_params(_int4), so
no whole bf16 LLM is ever held. Loading checkpoints and meshes are not
ported yet.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from video_llava_tpu_torch.config import (
    CLIPVisionConfig,
    GenerationConfig,
    LlamaConfig,
    VideoLLaVAConfig,
)
from video_llava_tpu_torch.engine.convert import flatten_tree
from video_llava_tpu_torch.models.layers import Int8Kernel
from video_llava_tpu_torch.models.llama import (
    Llama,
    fuse_layer_kernels,
    layer_layout,
)
from video_llava_tpu_torch.models.video_llava import VideoLLaVA
from video_llava_tpu_torch.ops.quant import quantize_params
from video_llava_tpu_torch.ops.quant4 import quantize_params_int4
from video_llava_tpu_torch.runtime.inference import InferenceEngine
from video_llava_tpu_torch.runtime.tokenizer import load_tokenizer


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
    N(0, 0.02^2), biases 0, norm scales 1. Quantized leaves are left to
    :func:`random_init_quantized_llm_`."""
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("qvalues_packed", "qvalues", "scales"):
            continue
        if leaf == "bias":
            p.zero_()
        elif leaf == "scale":
            p.fill_(1.0)
        elif leaf in ("kernel", "patch_embedding"):
            p.normal_(0.0, p.shape[0] ** -0.5, generator=generator)
        else:  # embed_tokens.weight, class/position embeddings
            p.normal_(0.0, 0.02, generator=generator)


@torch.no_grad()
def random_init_quantized_llm_(llm: Llama, generator: torch.Generator,
                               dtype: torch.dtype = torch.bfloat16) -> None:
    """Fill the quantized leaves of `llm`: each weight is drawn in
    `dtype` with the JAX package's init scale, then quantized with the
    port's quantize_params_int4 (or quantize_params for int8) and fused
    as the module's layout (llm.quant, llm.group_size, llm.fuse) says,
    one layer at a time on the device.
    (The JAX package's own random quantized init fills every byte with 3
    and every scale with 0.01, so all output channels are equal; this
    one draws real weights.)"""
    cfg, quant, group_size = llm.cfg, llm.quant, llm.group_size
    dev = llm.final_norm.scale.device
    quantize = functools.partial(
        quantize_params_int4 if quant == "int4" else quantize_params,
        min_size=0, **({"group_size": group_size} if quant == "int4"
                       else {}))
    params = dict(llm.named_parameters())

    def draw(shape, std):
        return torch.empty(shape, device=dev, dtype=dtype).normal_(
            0.0, std, generator=generator)

    def load(prefix, tree):
        for name, t in flatten_tree(tree).items():
            params[prefix + name].copy_(t)

    d, vocab = cfg.hidden_size, cfg.vocab_size
    top = {}
    if isinstance(llm.embed_tokens.weight, Int8Kernel):
        top["embed_tokens"] = {"weight": draw((vocab, d), 0.02)}
    if not isinstance(llm.lm_head.kernel, torch.Tensor):
        top["lm_head"] = {"kernel": draw((d, vocab), d ** -0.5)}
    load("", quantize(top))
    unfused = layer_layout(cfg, quant, group_size)
    for li in range(cfg.num_layers):
        tree = quantize({name: {"kernel": draw((i, o), i ** -0.5)}
                         for name, (i, o, fmt, _) in unfused.items() if fmt})
        if llm.fuse:
            tree = fuse_layer_kernels({"layers": tree})["layers"]
        load(f"layers.{li}.", tree)


def initialize_model(
    model_name: Optional[str] = None,
    model_size: str = "7b",
    device="cuda",
    seed: int = 0,
    dtype: torch.dtype = torch.bfloat16,
    image_size: int = 224,
    llm_quant: Optional[str] = None,
    llm_fuse: bool = False,
) -> InferenceEngine:
    """Build an InferenceEngine with random weights made on `device`.
    llm_quant: None, "int8" or "int4" weights-only LLM quantization
    (the JAX package's layouts, made without a whole bf16 LLM);
    llm_fuse: the fused wqkv/gate_up layout. model_name (a checkpoint
    directory) is not supported yet; the tokenizer is the byte-level
    fallback."""
    if llm_quant not in (None, "int8", "int4"):
        raise ValueError(f"llm_quant: None, int8 or int4; got {llm_quant}")
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
    model = VideoLLaVA(cfg, device=device, dtype=dtype, llm_quant=llm_quant,
                       llm_fuse=llm_fuse)
    generator = torch.Generator(device=device).manual_seed(seed)
    random_init_(model, generator)
    if llm_quant:
        random_init_quantized_llm_(model.llm, generator, dtype=dtype)
    return InferenceEngine(
        model=model, cfg=cfg, tokenizer=tokenizer,
        gen=GenerationConfig(eos_token_id=tokenizer.eos_token_id,
                             pad_token_id=tokenizer.pad_token_id),
    )
