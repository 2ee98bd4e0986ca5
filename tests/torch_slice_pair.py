"""The tiny VideoLLaVA pair (JAX engine, port engine on the same f32
parameters) that the chat-slice parity tests share: a module-scoped
fixture, imported by each tests/test_torch_slice*.py file."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from video_llava_tpu.config import (
    GenerationConfig,
    LlamaConfig,
    VideoLLaVAConfig,
)
from video_llava_tpu.models import video_llava as jax_vl
from video_llava_tpu.runtime.inference import InferenceEngine as JaxEngine
from video_llava_tpu.runtime.tokenizer import ByteTokenizer
from video_llava_tpu_torch.engine.convert import params_from_jax
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
