"""PGVideoLLaVA.answer end to end on the tiny VideoLLaVA pair
(tests/torch_slice_pair.py) and tiny grounding stacks on both sides
(GroundingDINO, MobileSAM, the STM tracker on its whole-clip path, a
Swin tagger at 384 px, entity matching through a stub client), the
output video's encoder replaced by a recorder: the same LLM text, the
same tags sent to the matcher, the same match_state and highlights, the
same scenes and per-frame objects, and the per-frame soft masks (the
tracker's default) within 1e-3 except on at most 0.5% of pixels (where
a SAM logit within rounding of 0 flips a detection mask pixel). The tag threshold sits in a gap of the
tag probabilities (> 1e-3 from each), so no tag is decided by rounding."""

import numpy as np
import jax.numpy as jnp

import video_llava_tpu.media.loader as j_loader
from torch_grounding_pair import (
    StubClient,
    dino_pair,
    moving_squares,
    sam_segmenters,
    tagger_pair,
)
from torch_slice_pair import slice_pair  # noqa: F401 (fixture)
from video_llava_tpu.grounding import entity_matching as jem
from video_llava_tpu.grounding import tagging as jtag
from video_llava_tpu.grounding.memory_tracker import (
    TrackerConfig as JTrackerConfig,
)
from video_llava_tpu.grounding.tracker import GroundedTracker as JTracker
from video_llava_tpu.models import grounding_dino as jgd
from video_llava_tpu.models import swin as jswin
from video_llava_tpu.runtime.chat import PGVideoLLaVA as JaxGrounded
from video_llava_tpu_torch.grounding import entity_matching as tem
from video_llava_tpu_torch.grounding import tagging as ttag
from video_llava_tpu_torch.grounding.memory_tracker import TrackerConfig
from video_llava_tpu_torch.grounding.tracker import GroundedTracker
from video_llava_tpu_torch.models import grounding_dino as tgd
from video_llava_tpu_torch.models import swin as tswin
from video_llava_tpu_torch.runtime import chat as tchat

TAGS = [f"tag{i}" for i in range(20)]


def _gap_threshold(probs):
    """A threshold near the median with no probability within 1e-3."""
    p = np.sort(probs.ravel())
    mid = len(p) // 2
    for i in sorted(range(1, len(p)), key=lambda i: abs(i - mid)):
        if p[i] - p[i - 1] > 2e-3:
            return float((p[i] + p[i - 1]) / 2)
    raise AssertionError("no gap in the tag probabilities")


def _record(tracker, runs):
    inner = tracker.run_on_list_of_images

    def run(frames, classes):
        out = inner(frames, classes)
        runs.append((list(classes), out))
        return out

    tracker.run_on_list_of_images = run


def test_grounded_answer_matches_jax(slice_pair, tmp_path, monkeypatch):
    jax_engine, engine = slice_pair
    frames = moving_squares(10, 48, 80, seed=3)
    (jb, jh), (tb, th) = tagger_pair(len(TAGS))
    logits = jtag.TaggingModule(jb, jh, jswin.SwinConfig.tiny_test(),
                                TAGS)._raw_fwd(384)(jb, jh,
                                                    jnp.asarray(frames))
    thr = _gap_threshold(1 / (1 + np.exp(-np.asarray(logits))))
    jp, tp = dino_pair()
    jseg, tseg = sam_segmenters()
    tok = tgd.char_tokenize
    videos = []
    monkeypatch.setattr(j_loader, "encode_video",
                        lambda path, f, fps: videos.append(("jax", f)))
    monkeypatch.setattr(tchat, "encode_video",
                        lambda path, f, fps: videos.append(("port", f)))

    jt = JTracker(detector=jgd.GroundingDinoDetector(
        jp, jgd.GroundingDinoConfig.tiny_test(), tok, image_size=64),
        segmenter=jseg, tracker_cfg=JTrackerConfig(max_objects=3))
    tt = GroundedTracker(detector=tgd.GroundingDinoDetector(
        tp, tgd.GroundingDinoConfig.tiny_test(), tok, image_size=64),
        segmenter=tseg, tracker_cfg=TrackerConfig(max_objects=3))
    assert jt.fused_eligible() and tt.fused_eligible()
    jruns, truns = [], []
    _record(jt, jruns)
    _record(tt, truns)
    stubs = StubClient(n=2), StubClient(n=2)
    jchat = JaxGrounded(
        jax_engine, jt,
        jtag.TaggingModule(jb, jh, jswin.SwinConfig.tiny_test(), TAGS,
                           threshold=thr),
        jem.EntityMatchingModule(client=stubs[0]), temperature=0.0,
        max_output_tokens=6)
    tchat_ = tchat.PGVideoLLaVA(
        engine, tt,
        ttag.TaggingModule(tb, th, tswin.SwinConfig.tiny_test(), TAGS,
                           threshold=thr),
        tem.EntityMatchingModule(client=stubs[1]), temperature=0.0,
        max_output_tokens=6)
    jchat.video_frames = frames
    jchat.video_features = jax_engine.encode_video_frames(
        frames, num_valid_frames=len(frames))
    tchat_.upload_frames(frames)
    outs = []
    for chat in (jchat, tchat_):
        chat.add_text("Where is the dog?", None)
        outs.append(chat.answer(output_dir=str(tmp_path)))
    (jtext, jpath, jhigh, jmatch), (ttext, tpath, thigh, tmatch) = outs
    assert ttext == jtext
    assert stubs[1].requests == stubs[0].requests
    assert tmatch == jmatch and len(tmatch) == 2
    assert thigh == jhigh
    assert (tpath is None) == (jpath is None) and tpath is not None
    assert [c for c, _ in truns] == [c for c, _ in jruns]
    n = 0
    for (_, got), (_, want) in zip(truns, jruns):
        for g, w in zip(got, want):
            assert [(o.id, o.category_id) for o in g.objects] == [
                (o.id, o.category_id) for o in w.objects]
            assert g.masks.dtype == w.masks.dtype == np.float32
            assert np.mean(np.abs(g.masks - w.masks) > 1e-3) <= 5e-3
            n += 1
    assert n == len(frames)
    assert any(r.masks.any() for _, run in truns for r in run)
    (jname, jvid), (tname, tvid) = videos
    assert (jname, tname) == ("jax", "port")
    assert tvid.shape == jvid.shape == (10, 48, 80, 3)


def test_zz_grounding_stack_builds_at_full_width():
    """build_grounding_stack's default configuration, drawn on the meta
    device (shapes only): GroundingDINO Swin-T with 4 levels and 900
    queries, MobileSAM at 1024 px, the Swin-L tagger over the default tag
    list; the unported options raise, a missing XMem file warns and keeps
    the STM, a missing CLIP directory raises; and random_clip_filter's
    ViT-B/32 towers."""
    import pytest

    from video_llava_tpu_torch.grounding.builders import (
        DEFAULT_TAG_LIST,
        build_grounding_stack,
        random_clip_filter,
    )
    from video_llava_tpu_torch.grounding.memory_tracker import MemoryTracker

    tracker, tagger, matcher = build_grounding_stack(device="meta")
    det = tracker.detector
    assert det.params["query_embeds"].shape == (900, 256)
    assert det.params["level_embed"].shape == (4, 256)
    assert det.params["input_proj"][3]["conv"]["kernel"].shape == (
        3, 3, 768, 256)
    assert tracker.segmenter.cfg.vision.image_size == 1024
    assert tracker.fused_eligible() and tracker.tracker_cfg.max_objects == 5
    assert tagger.head_params["head"]["kernel"].shape == (
        1536, len(DEFAULT_TAG_LIST))
    for kw in ({"sam_variant": "vit_b"}, {"dino_checkpoint": "d"}):
        with pytest.raises(NotImplementedError):
            build_grounding_stack(device="meta", **kw)
    with pytest.warns(UserWarning, match="not found"):
        stm = build_grounding_stack(device="meta",
                                    xmem_checkpoint="x.pth")[0]
    assert isinstance(stm.tracker, MemoryTracker)
    with pytest.raises(FileNotFoundError):
        build_grounding_stack(device="meta", clip_checkpoint="clip")
    f = random_clip_filter(device="meta")
    assert f.vision_cfg.patch_size == 32 and f.vision_cfg.num_layers == 12
    assert f.text_params["token_embedding"]["weight"].shape == (49408, 512)
    assert f.visual_projection["kernel"].shape == (768, 512)
