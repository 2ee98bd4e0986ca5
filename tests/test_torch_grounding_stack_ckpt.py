"""build_grounding_stack with both checkpoints, port against the JAX
package: a tiny HF CLIPModel directory (transformers, 2-layer towers of
width 32, model.safetensors, vocab.json + merges.txt of the tiny BPE
vocabulary) and an official-layout XMem training checkpoint ({'network':
state dict} of tests/test_xmem.py's module), written here. Inside the
test both builders take the tiny CLIP configs in place of their
ViT-L/14 defaults (their module names patched) and stub detectors,
segmenters and taggers (the full-width ones are not under test).

Both stacks hold the crop filter and the learned propagator; the port's
XMem tree equals the JAX package's carried across; the crop filters'
zero-shot weights agree within 1e-5 (the port's CLIP tokenizer against
AutoTokenizer, through each package's converters), and so do their
crop scores of 3 seeded 64 x 96 frames x 3 boxes. A checkpoint of other
sizes raises a clear error, and a missing XMem file warns and keeps the
STM. (tests/test_torch_xmem_checkpoint.py runs a converted checkpoint,
tests/test_torch_learned_fused.py the learned tracker.)"""

import json

import numpy as np
import jax
import pytest
import torch
import transformers

from test_xmem import TXMem
from torch_xmem_pair import (
    one_torch_thread,
    META,
    StubDetector,
    StubSegmenter,
    TEXT_KW,
    VISION_KW,
    clip_prompts,
    frames,
    tx,
    write_clip_vocab,
)
from video_llava_tpu.config import CLIPTextConfig as JTextCfg
from video_llava_tpu.config import CLIPVisionConfig as JVisionCfg
from video_llava_tpu.grounding import builders as jbuild
from video_llava_tpu.models import grounding_dino as jgd
from video_llava_tpu_torch.config import CLIPTextConfig, CLIPVisionConfig
from video_llava_tpu_torch.engine.convert import xmem_from_jax
from video_llava_tpu_torch.grounding import builders as tbuild
from video_llava_tpu_torch.grounding.memory_tracker import (
    LearnedMemoryTracker,
    MemoryTracker,
)
from video_llava_tpu_torch.models import grounding_dino as tgd


def write_clip_dir(d, vocab_size):
    text = dict(TEXT_KW, vocab_size=vocab_size)
    cfg = transformers.CLIPConfig(
        text_config=dict(hidden_size=text["hidden_size"],
                         intermediate_size=text["intermediate_size"],
                         num_hidden_layers=text["num_layers"],
                         num_attention_heads=text["num_heads"],
                         vocab_size=vocab_size, max_position_embeddings=77),
        vision_config=dict(hidden_size=VISION_KW["hidden_size"],
                           intermediate_size=VISION_KW["intermediate_size"],
                           num_hidden_layers=VISION_KW["num_layers"],
                           num_attention_heads=VISION_KW["num_heads"],
                           image_size=VISION_KW["image_size"],
                           patch_size=VISION_KW["patch_size"]),
        projection_dim=VISION_KW["projection_dim"])
    torch.manual_seed(0)
    transformers.CLIPModel(cfg).eval().save_pretrained(
        str(d), safe_serialization=True)
    with open(d / "tokenizer_config.json", "w") as f:
        json.dump({"tokenizer_class": "CLIPTokenizer"}, f)
    return text


@one_torch_thread()
def test_grounding_stack_with_checkpoints_matches_jax(tmp_path, monkeypatch):
    clip_dir = tmp_path / "clip"
    clip_dir.mkdir()
    vocab = write_clip_vocab(clip_dir)
    text = write_clip_dir(clip_dir, vocab)
    torch.manual_seed(1)
    tm = TXMem().eval()
    xmem_path = tmp_path / "XMem.pth"
    torch.save({"network": tm.state_dict()}, xmem_path)

    for mod, vcfg, tcfg in ((jbuild, JVisionCfg, JTextCfg),
                            (tbuild, CLIPVisionConfig, CLIPTextConfig)):
        monkeypatch.setattr(mod, "CLIPVisionConfig",
                            lambda c=vcfg: c(**VISION_KW))
        monkeypatch.setattr(mod, "CLIPTextConfig", lambda c=tcfg: c(**text))
        monkeypatch.setattr(mod, "build_sam",
                            lambda *a, **k: StubSegmenter())
        monkeypatch.setattr(mod, "build_tagger", lambda *a, **k: None)
    for mod in (jgd, tgd):
        monkeypatch.setattr(mod, "build_detector",
                            lambda *a, **k: StubDetector())

    kw = dict(clip_checkpoint=str(clip_dir), xmem_checkpoint=str(xmem_path),
              max_objects=3)
    jt, _, _ = jbuild.build_grounding_stack(**kw)
    tt, _, _ = tbuild.build_grounding_stack(device="cpu", **kw)
    assert isinstance(tt.tracker, LearnedMemoryTracker)
    assert tt.crop_filter is not None and tt.fused_eligible()
    assert tt.tracker.cfg == tx.XMemConfig(max_objects=3)

    carried = xmem_from_jax(jax.tree.map(np.asarray, jt.tracker.params),
                            tx.init_params(META, tt.tracker.cfg))
    flat_t = dict(_leaves(tt.tracker.params))
    for k, v in _leaves(carried):
        torch.testing.assert_close(flat_t[k], v, rtol=0, atol=0, msg=k)

    prompts = clip_prompts()[:10]
    assert ([tt.crop_filter.tokenize(p) for p in prompts]
            == [jt.crop_filter.tokenize(p) for p in prompts])
    classes = ["person", "dog"]
    np.testing.assert_allclose(
        tt.crop_filter.zeroshot_weights(classes).numpy(),
        np.asarray(jt.crop_filter.zeroshot_weights(classes)), atol=1e-5)
    clip = frames(3)
    boxes = np.stack([StubDetector().detect_batch(clip[:1], classes)[0][0]
                      for _ in range(3)])
    np.testing.assert_allclose(
        tt.crop_filter.score_frames_device(clip, boxes, classes),
        jt.crop_filter.score_frames_device(clip, boxes, classes), atol=1e-5)

    monkeypatch.setattr(tbuild, "CLIPVisionConfig",
                        lambda: CLIPVisionConfig(**dict(VISION_KW,
                                                        patch_size=7)))
    with pytest.raises(ValueError, match="patch_embedding"):
        tbuild.build_clip_filter(str(clip_dir), device="cpu")
    with pytest.warns(UserWarning, match="not found"):
        stm, _, _ = tbuild.build_grounding_stack(
            device="cpu", xmem_checkpoint=str(tmp_path / "missing.pth"))
    assert isinstance(stm.tracker, MemoryTracker) and stm.crop_filter is None


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}.{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}.{i}")
    else:
        yield path, tree
