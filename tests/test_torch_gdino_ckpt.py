"""GroundingDINO from checkpoints, port against the JAX package: a seeded
tiny HF GroundingDinoForObjectDetection state dict and its rewrite into
the original repo's schema (tests/test_grounding_dino.py's
_hf_sd_to_original_schema: fused in_proj, timm Swin keys, bert.*,
feat_map) go through both packages' convert_hf_grounding_dino and
convert_original_grounding_dino: the trees are equal leaf for leaf, to
each other and across the schemas. One forward of each package on the
converted weights agrees (logits and boxes within 1e-4 of their scale).
Then the port's build_detector from an original-repo .pth with a
vocab.txt directory as tokenizer_name, and from an HF directory with its
own tokenizer, on the CPU: the same tree, the same ids as
BertTokenizerFast; a tokenizer name that is not a directory raises with
the name; and grounding/synthetic.gdino_original_state writes the
port's tree back into the schema the converter reads, leaf for leaf."""

import numpy as np
import pytest
import torch
import jax

from test_grounding_dino import _hf_sd_to_original_schema
from torch_grounding_ckpt_pair import (
    assert_trees_equal,
    hf_grounding_dino_sd,
    one_torch_thread,
    rel_err,
)
from transformers import BertTokenizerFast
from video_llava_tpu.models import grounding_dino as jgd
from video_llava_tpu_torch.grounding import synthetic
from video_llava_tpu_torch.models import grounding_dino as tgd


def test_gdino_checkpoints_match_jax(tmp_path):
    jcfg, sd = hf_grounding_dino_sd()
    tcfg = tgd.GroundingDinoConfig.tiny_test()
    j_hf = jgd.convert_hf_grounding_dino(sd, jcfg)
    t_hf = tgd.convert_hf_grounding_dino(sd, tcfg)
    assert_trees_equal(j_hf, t_hf)
    orig = _hf_sd_to_original_schema(sd, jcfg)
    t_orig = tgd.convert_original_grounding_dino(orig, tcfg)
    assert_trees_equal(jgd.convert_original_grounding_dino(orig, jcfg),
                       t_orig)
    assert_trees_equal(t_hf, t_orig)

    rng = np.random.default_rng(0)
    px = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    ids = np.asarray([[101, 5, 6, 1012, 7, 8, 9, 1012, 102]] * 2)
    j_logits, j_boxes = jgd.forward(j_hf, jcfg, jax.numpy.asarray(px), ids)
    with one_torch_thread(), torch.inference_mode():
        t_logits, t_boxes = tgd.forward(t_hf, tcfg, torch.from_numpy(px),
                                        ids)
    j_logits, t_logits = np.asarray(j_logits), t_logits.numpy()
    fin = np.isfinite(j_logits)
    assert (np.isfinite(t_logits) == fin).all()
    assert rel_err(t_logits[fin], j_logits[fin]) < 1e-4
    assert rel_err(t_boxes.numpy(), np.asarray(j_boxes)) < 1e-4

    # build_detector: the original .pth with a BERT vocabulary directory
    vocab_dir = synthetic.write_bert_vocab(str(tmp_path / "bert"), 2048)
    pth = tmp_path / "groundingdino_tiny.pth"
    torch.save({"model": {"module." + k: torch.from_numpy(np.array(v))
                          for k, v in orig.items()}}, pth)
    det = tgd.build_detector(str(pth), tcfg, tokenizer_name=vocab_dir,
                             device="cpu")
    assert_trees_equal(t_hf, det.params)
    hf_tok = BertTokenizerFast(vocab_file=f"{vocab_dir}/vocab.txt")
    caption = "a man . the red dog ."
    assert det.tokenize(caption) == hf_tok(caption).input_ids
    with pytest.raises(FileNotFoundError, match="bert-base-uncased"):
        tgd.build_detector(str(pth), tcfg, device="cpu")

    # build_detector: an HF directory with its own tokenizer
    hf_dir = tmp_path / "hf"
    hf_dir.mkdir()
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
               hf_dir / "pytorch_model.bin")
    hf_tok.save_pretrained(str(hf_dir))
    det = tgd.build_detector(str(hf_dir), tcfg, device="cpu")
    assert_trees_equal(t_hf, det.params)
    assert det.tokenize(caption) == hf_tok(caption).input_ids

    # the released-layout writer is the converter's inverse
    written = synthetic.gdino_original_state(t_hf, tcfg)
    assert set(written) <= set(orig)
    assert_trees_equal(t_hf, tgd.convert_original_grounding_dino(written,
                                                                 tcfg))
