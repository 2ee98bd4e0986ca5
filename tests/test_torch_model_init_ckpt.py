"""initialize_model from checkpoints (runtime/model_init.py) against the
JAX package's, at the tiny configuration: an HF LLaMA directory
(safetensors shards and a tokenizer.json), a CLIPVisionModel directory
and an mm_projector.bin, in bf16 and at --quant int4 with the fused
layout (there the JAX package's initialize_model raises on the
projector overlay, so its reference is its bf16 load with the LLM
quantized by the host quantizer its checkpoint branch applies). The
tokenizers agree (the video ids the checkpoint's: 400-402);
every parameter equals the JAX package's initialize_model tree carried
across by engine/convert.py (exact, but for the mean-initialised rows
of the embedding and lm_head, within one bf16 ulp: an f32 mean summed in
another order, then rounded); the first turn's next-token logits (CLIP,
pooling, projector, the splice and the prefill) agree within 2e-2 of
their max |ref| (bf16 activations on both sides, in another order)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_ckpt_pair import BASE_VOCAB, write_videollava_checkpoint
from video_llava_tpu.models import video_llava as jax_vl
from video_llava_tpu.runtime import model_init as jax_init
from video_llava_tpu_torch.config import VideoLLaVAConfig
from video_llava_tpu_torch.engine.convert import params_from_jax
from video_llava_tpu_torch.runtime.conversation import conv_templates
from video_llava_tpu_torch.runtime.inference import build_video_question
from video_llava_tpu_torch.runtime.model_init import initialize_model

ULP = 2.0 ** -7  # one bf16 ulp, relative


def test_initialize_model_from_checkpoints_matches_jax(tmp_path):
    paths = write_videollava_checkpoint(str(tmp_path),
                                        VideoLLaVAConfig.tiny().vision)
    frames = np.random.default_rng(0).integers(0, 256, (6, 64, 64, 3),
                                               dtype=np.uint8)
    jax_bf16 = jax_init.initialize_model(
        paths["llm"], paths["projector"], paths["clip"], model_size="tiny")
    for quant in (None, "int4"):
        kw = dict(llm_quant=quant, llm_fuse=bool(quant))
        engine = initialize_model(paths["llm"], paths["projector"],
                                  paths["clip"], model_size="tiny",
                                  device="cpu", **kw)
        if quant:
            # the JAX package's int4 load raises on the projector overlay
            # (it reads .shape of the quantized embedding): its reference
            # is its bf16 load with the LLM quantized by the host
            # quantizer its initialize_model applies to a checkpoint
            with pytest.raises(AttributeError):
                jax_init.initialize_model(
                    paths["llm"], paths["projector"], paths["clip"],
                    model_size="tiny", **kw)
            jeng = dataclasses.replace(jax_bf16, params={
                **jax_bf16.params, "llm": jax_init._host_quantize_llm(
                    jax.tree.map(np.asarray, jax_bf16.params["llm"]),
                    jax_bf16.cfg, quant, True)})
        else:
            jeng = jax_bf16
        tok, jtok = engine.tokenizer, jeng.tokenizer
        assert (tok.vid_patch_token_id, tok.vid_start_token_id,
                tok.vid_end_token_id) == (
            jtok.vid_patch_token_id, jtok.vid_start_token_id,
            jtok.vid_end_token_id) == (BASE_VOCAB, BASE_VOCAB + 1,
                                       BASE_VOCAB + 2)
        assert engine.cfg == engine.cfg.__class__(**{
            f: getattr(jeng.cfg, f) for f in ("vid_patch_token_id",
                                              "vid_start_token_id",
                                              "vid_end_token_id")},
            vision=engine.cfg.vision, llm=engine.cfg.llm)
        carried = dict(params_from_jax(
            jax.tree.map(np.asarray, jeng.params), engine.cfg)
            .named_parameters())
        own = dict(engine.model.named_parameters())
        assert set(own) == set(carried)
        for name, p in own.items():
            q = carried[name]
            assert p.dtype == q.dtype and p.shape == q.shape, name
            rows = ("embed_tokens.weight" in name or "lm_head.kernel" in name)
            if rows and p.is_floating_point():  # the mean-init rows
                a, b = p.float(), q.float()
                err = (a - b).abs().amax().item()
                assert err <= ULP * b.abs().amax().item(), (name, err)
            else:
                assert torch.equal(p, q), name

        # the first turn's next-token logits
        conv = conv_templates["video-chatgpt_v1"].copy()
        conv.append_message(conv.roles[0], build_video_question(
            "What is in the video?", engine.cfg.video_token_len, True))
        conv.append_message(conv.roles[1], None)
        prompt = conv.get_prompt()
        ids = tok.encode(prompt)
        assert ids == jtok.encode(prompt)
        feats = engine.encode_video_frames(frames)
        jfeats = jeng.encode_video_frames(frames)
        n = len(ids)
        with torch.inference_mode():
            got = engine.model.prefill(
                torch.tensor([ids]), torch.tensor([n]), feats[None],
                n).logits_last[0].float().numpy()
        want = np.asarray(jax_vl.prefill(
            jeng.params, jeng.cfg, jnp.asarray([ids]), jnp.asarray([n]),
            jfeats[None], n).logits_last[0], np.float32)
        rel = np.abs(got - want).max() / np.abs(want).max()
        assert rel <= 2e-2, (quant, rel)
