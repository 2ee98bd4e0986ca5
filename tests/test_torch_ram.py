"""RAM's tag decoder (models/ram.py) and the RAM tagger, port against the
JAX package, on tests/test_ram.py's released-layout synthetic state dict
(a timm Swin under visual_encoder, label_embed with wordvec_proj,
image_proj, the q2l tagging head, fc, class_threshold), with and without
the query self-attention: infer_ram_config and convert_ram_checkpoint
give equal configs, trees (leaf for leaf, wordvec_proj folded into the
label embeddings) and thresholds, and engine/convert.ram_from_jax
carries the JAX decoder into the same tree; tag_logits agrees on seeded
pixels within 1e-4 of the logits' scale, and TaggingModule
.with_ram_decoder with the per-tag thresholds gives the same tags. The
tag list and threshold loaders read the same files (a count other than
the tags' raises in both). The port's build_tagger reads the checkpoint
file with the tag list and thresholds on the CPU, refuses a tag list of
another length, and grounding/synthetic.ram_state writes the tree back
into the release's layout."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from test_ram import _synthetic_ram_state_dict
from torch_grounding_ckpt_pair import (
    assert_trees_equal,
    one_torch_thread,
    rel_err,
)
from video_llava_tpu.grounding.tagging import TaggingModule as JTagger
from video_llava_tpu.models import ram as jram
from video_llava_tpu.models.swin import SwinConfig as JSwinConfig
from video_llava_tpu_torch.engine.convert import ram_from_jax
from video_llava_tpu_torch.grounding import builders as tbuild
from video_llava_tpu_torch.grounding import synthetic
from video_llava_tpu_torch.grounding.tagging import TaggingModule
from video_llava_tpu_torch.models import ram as tram
from video_llava_tpu_torch.models.swin import SwinConfig


def test_ram_checkpoint_and_tagger_match_jax(tmp_path):
    jswin, tswin = JSwinConfig.tiny_test(), SwinConfig.tiny_test()
    jcfg = jram.RamConfig(num_tags=12, hidden_size=32, num_heads=4,
                          decoder_layers=2, intermediate_size=64)
    px = np.random.default_rng(5).normal(size=(3, 64, 64, 3)).astype(
        np.float32)
    for self_attn in (True, False):
        sd = _synthetic_ram_state_dict(jswin, jcfg, np.random.default_rng(0),
                                       with_self_attn=self_attn)
        tcfg = tram.infer_ram_config(sd)
        assert dataclasses_equal(jram.infer_ram_config(sd), tcfg)
        jb, jp, jthr = jram.convert_ram_checkpoint(sd, jswin, jcfg)
        tb, tp, tthr = tram.convert_ram_checkpoint(sd, tswin, tcfg)
        assert_trees_equal(jb, tb)
        assert_trees_equal(jp, tp)
        np.testing.assert_array_equal(jthr, tthr)
        assert ("self" in tp["layers"][0]) == self_attn
        assert_trees_equal(tp, ram_from_jax(jax.tree.map(np.asarray, jp),
                                            tcfg, tswin.num_features))

        want = np.asarray(jram.tag_logits(jb, jp, jnp.asarray(px), jswin,
                                          jcfg))
        with one_torch_thread(), torch.inference_mode():
            got = tram.tag_logits(tb, tp, torch.from_numpy(px), tswin,
                                  tcfg).numpy()
        assert got.shape == (3, 12)
        assert rel_err(got, want) < 1e-4

    # per-tag thresholds through both taggers (last: no self-attention)
    tags = [f"tag{i}" for i in range(12)]
    thr = np.random.default_rng(2).uniform(0.3, 0.7, 12).astype(np.float32)
    jt = JTagger.with_ram_decoder(jb, jp, jswin, jcfg, tags, threshold=thr)
    tt = TaggingModule.with_ram_decoder(tb, tp, tswin, tcfg, tags,
                                        threshold=thr)
    with one_torch_thread():
        got_tags = tt.run_on_frames(px)
    assert got_tags == jt.run_on_frames(px)
    assert any(got_tags) and not all(len(t) == 12 for t in got_tags)

    # the released tag list and thresholds files
    tag_file, thr_file = tmp_path / "ram_tag_list.txt", tmp_path / "thr.txt"
    tag_file.write_text("\n".join(tags) + "\n\n")
    thr_file.write_text("\n".join(f"{v:.6f}" for v in thr))
    assert tram.load_tag_list(str(tag_file)) == jram.load_tag_list(
        str(tag_file)) == tags
    np.testing.assert_array_equal(
        tram.load_tag_thresholds(str(thr_file), 12),
        jram.load_tag_thresholds(str(thr_file), 12))
    np.testing.assert_array_equal(tram.load_tag_thresholds(None, 3),
                                  jram.load_tag_thresholds(None, 3))
    for mod in (tram, jram):
        with pytest.raises(ValueError, match="expected 11"):
            mod.load_tag_thresholds(str(thr_file), 11)

    # build_tagger from the checkpoint file (self-attention kept out)
    path = tmp_path / "ram_tiny.pth"
    torch.save({"model": {"module." + k: torch.from_numpy(np.array(v))
                          for k, v in sd.items()}}, path)
    tagger = tbuild.build_tagger(
        cfg=tswin, ram_checkpoint=str(path), tag_list_path=str(tag_file),
        threshold_path=str(thr_file), device="cpu")
    assert tagger.tag_list == tags
    np.testing.assert_array_equal(tagger.threshold,
                                  tram.load_tag_thresholds(str(thr_file), 12))
    assert_trees_equal(tb, tagger.backbone_params)
    assert_trees_equal(tp, tagger.head_params)
    with pytest.raises(ValueError, match="12 tags"):
        tbuild.build_tagger(cfg=tswin, ram_checkpoint=str(path),
                            tag_list=tags[:5], device="cpu")

    # the writer: raw label embeddings and wordvec_proj give the fold back
    wordvec = {"kernel": torch.from_numpy(sd["wordvec_proj.weight"].T.copy()),
               "bias": torch.from_numpy(sd["wordvec_proj.bias"])}
    raw = {**tp, "label_embeddings": torch.from_numpy(sd["label_embed"])}
    written = synthetic.ram_state(tb, raw, tswin, wordvec, tthr)
    wb, wp, wthr = tram.convert_ram_checkpoint(written, tswin, tcfg)
    assert_trees_equal(tb, wb)
    assert_trees_equal(tp, wp)
    np.testing.assert_array_equal(tthr, wthr)


def dataclasses_equal(a, b) -> bool:
    import dataclasses

    return dataclasses.asdict(a) == dataclasses.asdict(b)
