"""The tiny training setup the port's training tests share (not
collected): a VideoLLaVA config small enough for the CPU, the JAX
package's f32 parameters for it, the port model on the same values, and
a batch whose rows carry a video block and different target counts."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import torch

from video_llava_tpu.config import LlamaConfig, VideoLLaVAConfig
from video_llava_tpu.constants import IGNORE_INDEX
from video_llava_tpu.models import video_llava as jax_vl
from video_llava_tpu.runtime.tokenizer import ByteTokenizer
from video_llava_tpu_torch.engine.convert import flatten_tree, params_from_jax


def tiny_cfg(num_kv_heads: int = 4, projector_type: str = "linear",
             num_layers: int = 2) -> VideoLLaVAConfig:
    """test_grad_accum.py's LLM (vocab 512, 2 layers, width 64, 4 heads
    of 16) with 8 temporal tokens (a 24-token video block) and the byte
    tokenizer's video token ids."""
    tok = ByteTokenizer()
    return dataclasses.replace(
        VideoLLaVAConfig.tiny(),
        llm=dataclasses.replace(
            LlamaConfig.tiny(vocab_size=512), num_layers=num_layers,
            hidden_size=64, intermediate_size=128, num_heads=4,
            num_kv_heads=num_kv_heads, head_dim=16),
        max_temporal_tokens=8, projector_type=projector_type,
        vid_patch_token_id=tok.vid_patch_token_id,
        vid_start_token_id=tok.vid_start_token_id,
        vid_end_token_id=tok.vid_end_token_id,
    )


def jax_params(cfg: VideoLLaVAConfig, seed: int = 0):
    return jax_vl.init_params(jax.random.PRNGKey(seed), cfg, jnp.float32)


def port_model(params, cfg: VideoLLaVAConfig):
    """The port's VideoLLaVA holding `params`' values (f32)."""
    return params_from_jax(jax.tree.map(np.asarray, params), cfg)


def batch_np(cfg: VideoLLaVAConfig, b: int = 4, s: int = 64,
             seed: int = 0) -> dict:
    """Rows of random text ids with <vid_start> patch x n <vid_end> at
    position 2; row i masks its first 30 + 3 i labels, so the rows (and
    any split of them) have different target counts."""
    rng = np.random.default_rng(seed)
    n = cfg.video_token_len
    ids = rng.integers(3, 250, size=(b, s)).astype(np.int32)
    ids[:, 2] = cfg.vid_start_token_id
    ids[:, 3:3 + n] = cfg.vid_patch_token_id
    ids[:, 3 + n] = cfg.vid_end_token_id
    labels = ids.copy()
    for i in range(b):
        labels[i, :30 + 3 * i] = IGNORE_INDEX
    feats = rng.standard_normal((b, n, cfg.vision.hidden_size)).astype(
        np.float32)
    return {"input_ids": ids, "labels": labels, "video_features": feats}


def as_jax(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def as_torch(batch: dict) -> dict:
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def flat(tree) -> dict:
    """A JAX tree as {port parameter name: numpy array} (None leaves,
    the frozen placeholders, dropped)."""
    return {k: np.asarray(v) for k, v in flatten_tree(tree).items()
            if v is not None}
