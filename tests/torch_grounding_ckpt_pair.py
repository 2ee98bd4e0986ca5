"""Shared pieces of the tests of the grounding stack from checkpoints:
tree comparison between the JAX package's trees (numpy leaves) and the
port's (tensors), and the tiny HF GroundingDINO and Swin models whose
state dicts both packages' converters read. Not collected (no test_
prefix)."""

import numpy as np
import torch
import jax

import transformers

from torch_xmem_pair import one_torch_thread  # noqa: F401 (shared)
from video_llava_tpu.models.grounding_dino import GroundingDinoConfig
from video_llava_tpu.models.swin import SwinConfig


def assert_trees_equal(want, got, path="tree"):
    """Every leaf of `got` (a port tree of tensors, or numpy) equal to
    `want`'s (a JAX tree, or a port tree) bit for bit, with the same keys
    and list lengths."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(want) == set(got), (
            path, sorted(want), sorted(got))
        for k in want:
            assert_trees_equal(want[k], got[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(want) == len(got), (path, len(want), len(got))
        for i, (a, b) in enumerate(zip(want, got)):
            assert_trees_equal(a, b, f"{path}.{i}")
    else:
        a = np.asarray(want.cpu() if isinstance(want, torch.Tensor)
                       else jax.device_get(want))
        b = np.asarray(got.cpu() if isinstance(got, torch.Tensor) else got)
        assert a.shape == b.shape, (path, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=path)


def rel_err(got, want) -> float:
    """max |got - want| / max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def hf_grounding_dino_sd():
    """(cfg, numpy state dict) of a seeded tiny HF
    GroundingDinoForObjectDetection at the tiny_test config (as
    tests/test_grounding_dino.py builds it)."""
    cfg = GroundingDinoConfig.tiny_test()
    hf_cfg = transformers.GroundingDinoConfig(
        d_model=cfg.d_model, num_queries=cfg.num_queries,
        encoder_layers=cfg.encoder_layers, decoder_layers=cfg.decoder_layers,
        encoder_attention_heads=cfg.encoder_attention_heads,
        decoder_attention_heads=cfg.decoder_attention_heads,
        encoder_ffn_dim=cfg.encoder_ffn_dim,
        decoder_ffn_dim=cfg.decoder_ffn_dim,
        num_feature_levels=cfg.num_feature_levels,
        max_text_len=cfg.max_text_len,
        backbone_config=transformers.SwinConfig(
            image_size=cfg.swin.image_size, patch_size=cfg.swin.patch_size,
            embed_dim=cfg.swin.embed_dim, depths=list(cfg.swin.depths),
            num_heads=list(cfg.swin.num_heads),
            window_size=cfg.swin.window_size,
            out_indices=[i + 1 for i in cfg.backbone_stage_indices]),
        text_config=transformers.BertConfig(
            vocab_size=cfg.text.vocab_size,
            hidden_size=cfg.text.hidden_size,
            num_hidden_layers=cfg.text.num_layers,
            num_attention_heads=cfg.text.num_heads,
            intermediate_size=cfg.text.intermediate_size,
            max_position_embeddings=cfg.text.max_position_embeddings),
    )
    torch.manual_seed(0)
    model = transformers.GroundingDinoForObjectDetection(hf_cfg).eval()
    return cfg, {k: v.numpy() for k, v in model.state_dict().items()}


def hf_swin_sd():
    """(cfg, numpy state dict) of a seeded tiny HF SwinModel at
    SwinConfig.tiny_test (tests/test_swin.py's)."""
    hf_cfg = transformers.SwinConfig(
        image_size=64, patch_size=4, embed_dim=24, depths=[2, 2],
        num_heads=[2, 4], window_size=4, attn_implementation="eager")
    torch.manual_seed(0)
    model = transformers.SwinModel(hf_cfg).eval()
    return SwinConfig.tiny_test(), {k: v.numpy()
                                    for k, v in model.state_dict().items()}

