"""The tiny VideoLLaVA pair (JAX engine, port engine on the same f32
parameters) that the chat-slice parity tests share: a module-scoped
fixture, imported by each tests/test_torch_slice*.py file; and the int4
slice comparison (compare_int4_slice) with its logit limits, shared by
the W4A8 and W4A16 int4 slice tests."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import video_llava_tpu.ops.quant4 as jax_quant4
from video_llava_tpu.config import (
    GenerationConfig,
    LlamaConfig,
    VideoLLaVAConfig,
)
from video_llava_tpu.models import llama as jax_llama
from video_llava_tpu.models import video_llava as jax_vl
from video_llava_tpu.models.llama import fuse_layer_kernels
from video_llava_tpu.runtime.inference import InferenceEngine as JaxEngine
from video_llava_tpu.runtime.tokenizer import ByteTokenizer
from video_llava_tpu_torch.engine.convert import params_from_jax
from video_llava_tpu_torch.models.layers import Int4Kernel, Int8Kernel
from video_llava_tpu_torch.runtime.inference import InferenceEngine


@pytest.fixture(scope="module")
def slice_pair():
    tok = ByteTokenizer()
    cfg = dataclasses.replace(
        VideoLLaVAConfig.tiny(),
        llm=LlamaConfig.tiny(vocab_size=512),  # most ids decode to bytes
        vid_patch_token_id=tok.vid_patch_token_id,
        vid_start_token_id=tok.vid_start_token_id,
        vid_end_token_id=tok.vid_end_token_id,
    )
    params = jax_vl.init_params(jax.random.PRNGKey(0), cfg, jnp.float32)
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg)
    gen = GenerationConfig(max_new_tokens=12, do_sample=False,
                           eos_token_id=tok.eos_token_id,
                           pad_token_id=tok.pad_token_id)
    jax_engine = JaxEngine(params=params, cfg=cfg, tokenizer=tok, gen=gen,
                           seq_pad_multiple=64, cache_dtype=jnp.float32,
                           speculative=False)
    engine = InferenceEngine(model=model, cfg=cfg, tokenizer=tok, gen=gen,
                             seq_pad_multiple=64,
                             cache_dtype=torch.float32, speculative=False)
    return jax_engine, engine


# The W4A8 slice's logit limits, fractions of max |logit| (max, mean):
# tests/test_torch_slice_int4.py says why; measured 2.4% and 0.61% there.
W4A8_LIMITS = (0.05, 0.01)


def check_logits(got, want, limits=W4A8_LIMITS):
    """max |err| and mean |err| within `limits` (max, mean) of max
    |logit|."""
    a, b = got.numpy(), np.asarray(want)
    err, scale = np.abs(a - b), np.abs(b).max()
    assert np.isfinite(a).all() and a.shape == b.shape
    assert err.max() <= limits[0] * scale, (err.max(), scale)
    assert err.mean() <= limits[1] * scale, (err.mean(), scale)


def check_greedy(got, want) -> bool:
    """The greedy token agrees wherever the JAX side's top-2 margin is
    more than twice the largest logit difference (there the bound alone
    decides the argmax); returns whether this step was decided."""
    a, b = got.numpy()[0], np.asarray(want)[0]
    top = np.sort(b)[-2:]
    if top[1] - top[0] <= 2 * np.abs(a - b).max():
        return False
    assert a.argmax() == b.argmax()
    return True


def compare_int4_slice(monkeypatch, jax_int4_matmul, limits=W4A8_LIMITS):
    """The int4 chat slice, port against JAX: a tiny VideoLLaVA whose LLM
    is quantized with the JAX package's quantize_params_int4 and fused,
    carried across with engine/convert.py (hidden 256, 4 x 64 heads,
    intermediate 512, g = 128, so every layer kernel packs to int4; vocab
    500 sends lm_head to int8, as Vicuna-7B's 32006 does, and the
    embedding is int8). The JAX package's int4 dispatch is patched for
    the test to `jax_int4_matmul` (x, packed, scales) and its stacked
    form takes the layer's slice. Prefill logits, then 4 greedy decode
    steps fed the JAX side's tokens, f32 cache; the bytes of the
    quantized leaves arrive unchanged; logits within `limits` and
    greedy tokens where check_greedy decides them."""

    def stacked(x, packed, scales, layer):
        take = lambda a: jax.lax.dynamic_index_in_dim(  # noqa: E731
            a, layer, 0, keepdims=False)
        return jax_int4_matmul(x, take(packed), take(scales))

    monkeypatch.setattr(jax_quant4, "int4_matmul", jax_int4_matmul)
    monkeypatch.setattr(jax_quant4, "int4_matmul_stacked", stacked)
    tok = ByteTokenizer()
    cfg = dataclasses.replace(
        VideoLLaVAConfig.tiny(),
        llm=dataclasses.replace(LlamaConfig.tiny(vocab_size=500),
                                num_heads=4, num_kv_heads=4, head_dim=64,
                                intermediate_size=512),
        vid_patch_token_id=tok.vid_patch_token_id,
        vid_start_token_id=tok.vid_start_token_id,
        vid_end_token_id=tok.vid_end_token_id,
    )
    params = jax_vl.init_params(jax.random.PRNGKey(0), cfg, jnp.float32)
    params = {**params, "llm": fuse_layer_kernels(
        jax_quant4.quantize_params_int4(params["llm"]))}
    tree = jax.tree.map(np.asarray, params)
    model = params_from_jax(tree, cfg)
    layer = model.llm.layers[2]
    assert isinstance(layer.wqkv.kernel, Int4Kernel)
    assert isinstance(layer.gate_up.kernel, Int4Kernel)
    assert isinstance(model.llm.lm_head.kernel, Int8Kernel)
    assert isinstance(model.llm.embed_tokens.weight, Int8Kernel)
    jl = tree["llm"]["layers"]
    np.testing.assert_array_equal(layer.down.kernel.qvalues_packed.numpy(),
                                  jl["down"]["kernel"]["qvalues_packed"][2])
    np.testing.assert_array_equal(
        layer.wqkv.kernel.scales.view(torch.int16).numpy(),
        jl["wqkv"]["kernel"]["scales"][2].view(np.int16))

    engine = InferenceEngine(model=model, cfg=cfg, tokenizer=tok,
                             seq_pad_multiple=64, cache_dtype=torch.float32)
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, size=(6, 64, 64, 3), dtype=np.uint8)
    feats = engine.encode_video_frames(frames)
    prompt = "Describe the video.\n" + "<vid_start>" + (
        "<vid_patch>" * cfg.video_token_len) + "<vid_end>"
    input_ids, seq_lens, s_real = engine.padded_prompt(prompt)
    jids = jnp.asarray(input_ids.numpy().astype(np.int32))
    jlens = jnp.asarray([s_real], jnp.int32)
    jfeats = jnp.asarray(feats.numpy())

    want = jax_vl.prefill(params, cfg, jids, jlens, jfeats[None], 256,
                          cache_dtype=jnp.float32)
    got = model.prefill(input_ids, seq_lens, feats[None], 256,
                        cache_dtype=torch.float32)
    check_logits(got.logits_last, want.logits_last, limits)
    # greedy decode, both sides fed the JAX side's tokens
    jcache, tcache = want.cache, got.cache
    want_logits, got_logits = want.logits_last, got.logits_last
    decided = 0
    for _ in range(4):
        token = np.asarray(jnp.argmax(want_logits, axis=-1), np.int32)
        decided += check_greedy(got_logits, want_logits)
        want_logits, jcache = jax_llama.decode_step(
            params["llm"], cfg.llm, jnp.asarray(token), jcache)
        got_logits, tcache = model.llm.decode_step(torch.from_numpy(token),
                                                   tcache)
        check_logits(got_logits, want_logits, limits)
    decided += check_greedy(got_logits, want_logits)
    assert decided >= 2
