"""Model initialization: random weights or a checkpoint.

Counterpart of video_llava_tpu/runtime/model_init.py::initialize_model
(reference video_chatgpt/eval/model_utils.py:82-150): the configuration
by size, the tokenizer (a checkpoint directory's own, else the byte
fallback) and the video special token ids from it, then the weights:
drawn on the device from a seeded ``torch.Generator`` with the JAX
package's init scales, and overwritten where a checkpoint is given --
the LLM from `model_name`, the CLIP tower from `clip_path`, then the
non-strict projector overlay from `projection_path` (engine/weights.py).
Paths that are not there fall back to random init, as in the JAX package.
``clip_dtype`` ('int8', or 'auto' by the checkpoint's preflight record)
makes the CLIP tower W8A8 on the device after any ``clip_path`` load.
With ``llm_quant`` the LLM's weights arrive one layer at a time in bf16,
drawn or read, and are quantized on the device with the port's
quantize_params(_int4), so no whole bf16 LLM is ever held (the JAX
package builds one on the device before it loads a checkpoint, and its
overlay raises on a quantized embedding: the port does neither).

``mesh_model`` > 1 (tensor parallel, JAX model_init.py:182-190): the
caller has started the ranks (parallel/driver.start); every rank draws
(or reads) the whole seeded model on its device, optionally pads the
vocab (``vocab_multiple``, models/llama.pad_vocab), keeps its shard
(parallel/sharding.shard_params), registers the meshes and the engine.
The peak on a rank is the whole model plus the largest parameter's
shard, before the rest of the whole model is freed.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Optional

import torch

from video_llava_tpu_torch.config import (
    CLIPVisionConfig,
    GenerationConfig,
    LlamaConfig,
    VideoLLaVAConfig,
)
from video_llava_tpu_torch.engine import weights
from video_llava_tpu_torch.engine.quant_select import resolve_clip_dtype
from video_llava_tpu_torch.engine.convert import flatten_tree
from video_llava_tpu_torch.models.clip import quantize_a8_
from video_llava_tpu_torch.models.layers import Int8Kernel
from video_llava_tpu_torch.models.llama import (
    Llama,
    fuse_layer_kernels,
    layer_layout,
    pad_vocab,
)
from video_llava_tpu_torch.models.video_llava import VideoLLaVA
from video_llava_tpu_torch.ops.quant import quantize_params
from video_llava_tpu_torch.ops.quant4 import quantize_params_int4
from video_llava_tpu_torch.parallel import driver
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
        if leaf in ("qvalues_packed", "qvalues", "qvalues_a8", "scales"):
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


def dtype_kwargs(flag: str) -> dict:
    """initialize_model's keyword for an entry point's --dtype flag:
    float32, or nothing for its bfloat16 default."""
    if flag not in ("bfloat16", "float32"):
        raise ValueError(f"--dtype: bfloat16 or float32, got {flag!r}")
    return {"dtype": torch.float32} if flag == "float32" else {}


def initialize_model(
    model_name: Optional[str] = None,
    projection_path: Optional[str] = None,
    clip_path: Optional[str] = None,
    model_size: str = "7b",
    device="cuda",
    seed: int = 0,
    dtype: torch.dtype = torch.bfloat16,
    image_size: int = 224,
    llm_quant: Optional[str] = None,
    llm_fuse: bool = False,
    clip_dtype: Optional[str] = None,
    mesh_model: Optional[int] = None,
    vocab_multiple: Optional[int] = None,
) -> InferenceEngine:
    """Build an InferenceEngine on `device`.
    model_name: an HF Vicuna/LLaMA checkpoint directory (tokenizer and
    LLM weights); projection_path: a reference-style mm_projector.bin;
    clip_path: an HF CLIP checkpoint directory. A path that is not there
    falls back to random init (and the byte tokenizer), as in the JAX
    package. llm_quant: None, "int8" or "int4" weights-only LLM
    quantization (the JAX package's layouts, made one layer at a time on
    the device); llm_fuse: the fused wqkv/gate_up layout. clip_dtype:
    None/'bf16' | 'auto' | 'int8', the W8A8 CLIP tower, resolved against
    clip_path's preflight record (engine/quant_select.resolve_clip_dtype)
    and quantized on the device with the JAX package's min_size of
    1 << 16 elements a stacked kernel (every kernel of ViT-L/14; a tiny
    configuration's may fall under it and stay in `dtype`).
    mesh_model: the tensor-parallel degree over the ranks started by
    parallel/driver.start (module docstring); llm_fuse must be off then.
    vocab_multiple: pad the vocab to a multiple of it (pad_vocab; its
    logit columns are masked)."""
    if llm_quant not in (None, "int8", "int4"):
        raise ValueError(f"llm_quant: None, int8 or int4; got {llm_quant}")
    if llm_fuse and mesh_model and mesh_model > 1:
        raise ValueError("llm_fuse is single-device only (TP shards "
                         "unfused names)")
    llm_dir = model_name if model_name and os.path.isdir(model_name) else None
    tokenizer = load_tokenizer(llm_dir)
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
    if llm_dir is None:
        random_init_(model, generator)
        if llm_quant:
            random_init_quantized_llm_(model.llm, generator, dtype=dtype)
    else:  # the LLM comes from the checkpoint: draw the rest only
        random_init_(model.vision, generator)
        random_init_(model.projector, generator)
        weights.convert_llama(weights.checkpoint_shards(llm_dir), model.llm)
    if clip_path and os.path.isdir(clip_path):
        weights.convert_clip_vision(weights.checkpoint_shards(clip_path),
                                    model.vision)
    if clip_dtype and clip_dtype != "bf16":
        resolved = resolve_clip_dtype(
            clip_dtype,
            clip_path if clip_path and os.path.isdir(clip_path) else None)
        if resolved == "int8":
            quantize_a8_(model.vision)
    if projection_path and os.path.exists(projection_path):
        report = weights.apply_projector_overlay(
            model, weights.load_torch_bin(projection_path))
        if report["unexpected"]:
            print(f"Unexpected Keys: {report['unexpected']}.\n"
                  "The Video-ChatGPT weights are not loaded correctly.")
    if vocab_multiple:
        pad_vocab(model.llm, vocab_multiple)
    if mesh_model and mesh_model > 1:
        from video_llava_tpu_torch.ops.attention import set_attention_mesh
        from video_llava_tpu_torch.ops.pooling import set_pooling_mesh
        from video_llava_tpu_torch.parallel import make_mesh, shard_params

        mesh = make_mesh(1, mesh_model)
        shard_params(model, mesh)
        set_attention_mesh(mesh)
        set_pooling_mesh(mesh)
    engine = InferenceEngine(
        model=model, cfg=cfg, tokenizer=tokenizer,
        gen=GenerationConfig(eos_token_id=tokenizer.eos_token_id,
                             pad_token_id=tokenizer.pad_token_id),
    )
    # what replicated calls name by reference (parallel/driver.py)
    for obj in (engine, model, tokenizer):
        driver.register(obj)
    return engine
