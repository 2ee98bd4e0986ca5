"""Port parity: the quantized LLM layout (models/llama.py) is the JAX
package's, at Vicuna-7B and 13B, from shapes alone (no weights)."""

import dataclasses

import numpy as np

from video_llava_tpu.config import LlamaConfig, VideoLLaVAConfig
from video_llava_tpu.runtime.model_init import _llm_quant_layout
from video_llava_tpu_torch.models.llama import Llama


def _shapes(tree, prefix=""):
    """{'layers.wq.kernel.qvalues_packed': (per-layer shape, dtype)}."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_shapes(v, path))
        else:
            shape = v.shape[1:] if path.startswith("layers.") else v.shape
            out[path] = (tuple(shape), np.dtype(v.dtype).name)
    return out


def test_quantized_llm_layout_matches_jax():
    """For int4 and int8, fused and not: every leaf of the JAX package's
    serving layout (quantize_params(_int4) then fuse_layer_kernels, over
    jax.eval_shape of init_params) has the port's name, per-layer shape
    and dtype, and the port has no other parameter. At 7B: int4 fused
    wqkv/gate_up, int4 wo/down (G/2 = 43 for down), int8 lm_head
    (vocab 32006) and int8 embedding."""
    for llm in (LlamaConfig.vicuna_7b(), LlamaConfig.vicuna_13b()):
        cfg = dataclasses.replace(VideoLLaVAConfig(), llm=llm)
        for quant in ("int4", "int8"):
            for fuse in (True, False):
                _, tree = _llm_quant_layout(cfg, quant, fuse)
                want = _shapes(tree)
                model = Llama(llm, device="meta", quant=quant, fuse=fuse)
                got = {}
                for name, p in model.named_parameters():
                    if name.startswith("layers.") and not name.startswith(
                            "layers.0."):
                        continue
                    key = name.replace("layers.0.", "layers.")
                    got[key] = (tuple(p.shape), str(p.dtype).split(".")[-1])
                assert got == want, (quant, fuse)
    _, tree = _llm_quant_layout(VideoLLaVAConfig(), "int4", True)
    seven = _shapes(tree)
    assert seven["layers.wqkv.kernel.qvalues_packed"] == ((2048, 12288),
                                                         "int8")
    assert seven["layers.down.kernel.scales"] == ((86, 4096), "bfloat16")
    assert seven["lm_head.kernel.qvalues"] == ((4096, 32006), "int8")
    assert seven["embed_tokens.weight.scales"] == ((32006, 1), "float32")
