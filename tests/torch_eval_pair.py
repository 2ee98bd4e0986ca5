"""The tiny VideoLLaVA pair the eval-runner parity tests share (JAX
engine, port engine on the same f32 parameters, carried across by the
port's engine/convert.py), built as tests/test_run_inference.py and
tests/test_batched_eval.py build the JAX side: greedy, 4 new tokens,
prompts padded to 64, an f32 cache; and the same mp4s, written by the
JAX package's media/loader.encode_video. Not collected: each
tests/test_torch_*eval*.py file imports the fixture."""

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
from video_llava_tpu.media.loader import encode_video
from video_llava_tpu.models import video_llava as jax_vl
from video_llava_tpu.runtime.inference import InferenceEngine as JaxEngine
from video_llava_tpu.runtime.tokenizer import ByteTokenizer
from video_llava_tpu_torch.engine.convert import params_from_jax
from video_llava_tpu_torch.runtime.inference import InferenceEngine

# (name, frames): tests/test_run_inference.py's two 12-frame clips and
# tests/test_batched_eval.py's three 6-frame ones (seeded as there)
CLIPS = (("clip_a", 12), ("clip_b", 12))
BATCH_CLIPS = (("a", 6), ("b", 6), ("c", 6))


def write_clips(vdir, clips, fps):
    rng = np.random.default_rng(0)
    for name, n in clips:
        frames = rng.integers(0, 255, size=(n, 64, 64, 3), dtype=np.uint8)
        encode_video(str(vdir / f"{name}.mp4"), frames, fps=fps,
                     codec="mpeg4")


def make_pair():
    """(JAX engine, port engine) on the same tiny f32 weights."""
    tok = ByteTokenizer()
    cfg = dataclasses.replace(
        VideoLLaVAConfig.tiny(),
        llm=LlamaConfig.tiny(vocab_size=512),
        vid_patch_token_id=tok.vid_patch_token_id,
        vid_start_token_id=tok.vid_start_token_id,
        vid_end_token_id=tok.vid_end_token_id,
    )
    # one compiled program (drawn op by op, each op compiles on its own:
    # ~60 compilations, the slowest part of a loaded tier run)
    params = jax.jit(lambda key: jax_vl.init_params(key, cfg, jnp.float32))(
        jax.random.PRNGKey(0))
    gen = GenerationConfig(max_new_tokens=4, do_sample=False)
    jax_engine = JaxEngine(params=params, cfg=cfg, tokenizer=tok, gen=gen,
                           seq_pad_multiple=64, cache_dtype=jnp.float32)
    engine = InferenceEngine(
        model=params_from_jax(jax.tree.map(np.asarray, params), cfg),
        cfg=cfg, tokenizer=tok, gen=gen, seq_pad_multiple=64,
        cache_dtype=torch.float32)
    assert engine.speculative == jax_engine.speculative
    return jax_engine, engine


@pytest.fixture(scope="module")
def eval_pair(tmp_path_factory):
    """(JAX engine, port engine, video dir of CLIPS, video dir of
    BATCH_CLIPS)."""
    jax_engine, engine = make_pair()
    vdir = tmp_path_factory.mktemp("videos")
    write_clips(vdir, CLIPS, fps=6)
    bdir = tmp_path_factory.mktemp("bvids")
    write_clips(bdir, BATCH_CLIPS, fps=3)
    return jax_engine, engine, str(vdir), str(bdir)
