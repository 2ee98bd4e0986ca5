"""Port parity for the int4 chat slice: a tiny VideoLLaVA whose LLM is
quantized with the JAX package's quantize_params_int4, fused with
fuse_layer_kernels and carried across with engine/convert.py.

Every layer kernel packs to int4 (hidden 256, 4 x 64 heads, intermediate
512, g = 128); vocab 500 is not a multiple of 128, so lm_head falls back
to int8, as Vicuna-7B's 32006 does, and the embedding table is int8.

JAX on the CPU runs the W4A16 twin for int4 kernels (quant4.py:858-859),
not what the TPU runs. So the JAX dispatch is patched for this test to
the TPU's W4A8 dispatch over its XLA twins -- up to A8_MAX_BATCH rows
int4_matmul_w4a8_xla per row, more rows int4_matmul_w4a8_block_xla --
which is what the port runs on the CPU (its plain versions) and on the
card (its kernels). The JAX package itself is not changed.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import torch

import video_llava_tpu.ops.quant4 as jax_quant4
from video_llava_tpu.config import (
    LlamaConfig,
    VideoLLaVAConfig,
)
from video_llava_tpu.models import llama as jax_llama
from video_llava_tpu.models import video_llava as jax_vl
from video_llava_tpu.models.llama import fuse_layer_kernels
from video_llava_tpu.runtime.tokenizer import ByteTokenizer
from video_llava_tpu_torch.engine.convert import params_from_jax
from video_llava_tpu_torch.models.layers import Int4Kernel, Int8Kernel
from video_llava_tpu_torch.runtime.inference import InferenceEngine


def _jax_w4a8(x, packed, scales):
    """The TPU's int4 dispatch (quant4.py:854-866, 993-1025) with its
    Pallas kernels replaced by their XLA twins."""
    if packed.shape[-1] % 128:
        return jax_quant4.int4_matmul_xla(x, packed, scales)
    xb = x.reshape(-1, x.shape[-1])
    if xb.shape[0] <= jax_quant4.A8_MAX_BATCH:
        y = jnp.concatenate([
            jax_quant4.int4_matmul_w4a8_xla(xb[i:i + 1], packed, scales)
            for i in range(xb.shape[0])])
    else:
        y = jax_quant4.int4_matmul_w4a8_block_xla(xb, packed, scales)
    return y.reshape(x.shape[:-1] + (packed.shape[-1],))


def _jax_w4a8_stacked(x, packed, scales, layer):
    take = lambda a: jax.lax.dynamic_index_in_dim(  # noqa: E731
        a, layer, 0, keepdims=False)
    return _jax_w4a8(x, take(packed), take(scales))


def _check_logits(got, want):
    """max |err| <= 5% and mean |err| <= 1% of max |logit| (see the
    test's docstring for why; measured 2.4% and 0.61%)."""
    a, b = got.numpy(), np.asarray(want)
    err, scale = np.abs(a - b), np.abs(b).max()
    assert np.isfinite(a).all() and a.shape == b.shape
    assert err.max() <= 0.05 * scale, (err.max(), scale)
    assert err.mean() <= 0.01 * scale, (err.mean(), scale)


def _check_greedy(got, want) -> bool:
    """The greedy token agrees wherever the JAX side's top-2 margin is
    more than twice the largest logit difference (there the bound alone
    decides the argmax); returns whether this step was decided."""
    a, b = got.numpy()[0], np.asarray(want)[0]
    top = np.sort(b)[-2:]
    if top[1] - top[0] <= 2 * np.abs(a - b).max():
        return False
    assert a.argmax() == b.argmax()
    return True


def test_int4_slice_matches_jax(monkeypatch):
    """Prefill logits, then 4 greedy decode steps fed the JAX side's
    tokens, f32 cache; the bytes of the quantized leaves arrive
    unchanged.

    Tolerance: one int4 linear agrees to 1e-6 on the same input (both
    quantize activations by the same rule and form exact integer
    partials). But the int8 embedding returns bf16, so the LLM runs on
    bf16 activations (as in the JAX package), and a bf16 rounding that
    lands one way in one framework and the other in the other, or an f32
    sum in another order, moves an activation across an int8 rounding
    boundary: one step, 1/127 of its group's absmax. These steps add up
    through 4 layers. Scaling one video feature by 1.02 moves either
    package's own prefill logits by 2.4% (max) / 0.54% (mean) of their
    largest value; the port against JAX measured 2.0% / 0.51% at prefill
    and at most 2.4% / 0.61% over the decode steps. So logits are held to
    5% (max) and 1% (mean) of max |logit|, and greedy tokens must agree
    where that bound decides them."""
    monkeypatch.setattr(jax_quant4, "int4_matmul", _jax_w4a8)
    monkeypatch.setattr(jax_quant4, "int4_matmul_stacked", _jax_w4a8_stacked)
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
    _check_logits(got.logits_last, want.logits_last)
    # greedy decode, both sides fed the JAX side's tokens
    jcache, tcache = want.cache, got.cache
    want_logits, got_logits = want.logits_last, got.logits_last
    decided = 0
    for _ in range(4):
        token = np.asarray(jnp.argmax(want_logits, axis=-1), np.int32)
        decided += _check_greedy(got_logits, want_logits)
        want_logits, jcache = jax_llama.decode_step(
            params["llm"], cfg.llm, jnp.asarray(token), jcache)
        got_logits, tcache = model.llm.decode_step(torch.from_numpy(token),
                                                   tcache)
        _check_logits(got_logits, want_logits)
    decided += _check_greedy(got_logits, want_logits)
    assert decided >= 2
