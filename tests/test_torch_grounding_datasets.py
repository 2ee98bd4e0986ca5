"""The VidSTG / HC-STVG pipeline's data side, port against the JAX
package: grounding/synthetic writes raw VidOR + VidSTG annotations and
HC-STVG v2 val annotations (with empty videos to map); each package's
preprocess_grounding_annotations main turns its own copy into the
dataset files, and every file it writes is equal. Over those files,
VidSTGDataset (test split) and HCSTVGDataset of each package, with both
packages' _decode_frames replaced by the same seeded stand-in, give
equal samples: captions, query types, frame ids, the annotated indices
and their boxes, frames. Both packages' real _decode_frames (the native
libav reader) decode the same frames of an mpeg4 clip, repeated and past
the end ids included."""

import json
import os
import shutil

import numpy as np

from video_llava_tpu.datasets import grounding_datasets as jds
from video_llava_tpu.scripts import preprocess_grounding_annotations as jpre
from video_llava_tpu_torch.datasets import grounding_datasets as tds
from video_llava_tpu_torch.grounding import synthetic
from video_llava_tpu_torch.media.loader import encode_video
from video_llava_tpu_torch.scripts import (
    preprocess_grounding_annotations as tpre,
)


def _frames(video_path, frame_ids):
    return synthetic.seeded_frames(os.path.basename(video_path), frame_ids,
                                   hw=(36, 64))


def _samples(mod, vidstg_dir, vid_folder, hc_ann, hc_videos):
    vid = mod.VidSTGDataset(vidstg_dir, vid_folder, image_set="test")
    hc = mod.HCSTVGDataset(hc_ann, hc_videos)
    return [vid[i] for i in range(len(vid))] + [hc[i] for i in range(len(hc))]


def test_grounding_datasets_match_jax(tmp_path, monkeypatch):
    raw = tmp_path / "raw"
    synthetic.write_vidstg_annotations(str(raw / "vidor"), str(raw / "vidstg"),
                                       n_videos=2, frames=240)
    synthetic.write_hcstvg_annotations(str(raw / "hc_videos"),
                                       str(raw / "hc_ann"), n_videos=2,
                                       frames=200)
    outs = {}
    for name, pre in (("jax", jpre), ("port", tpre)):
        root = tmp_path / name
        shutil.copytree(raw, root)
        pre.main(["vidstg", "--vidor_annotations_dir", str(root / "vidor"),
                  "--vidstg_annotations_dir", str(root / "vidstg")])
        pre.main(["hcstvg", "--video_dir", str(root / "hc_videos"),
                  "--ann_dir", str(root / "hc_ann")])
        outs[name] = root
    written = sorted(
        os.path.relpath(os.path.join(d, f), outs["port"])
        for d, _, files in os.walk(outs["port"]) for f in files
        if f.endswith(".json"))
    assert {"vidstg/test.json", "vidstg/train.json",
            "vidstg/vidor_validation.json",
            "hc_ann/val_v2_proc.json"} <= set(written)
    for rel in written:
        with open(outs["jax"] / rel) as f, open(outs["port"] / rel) as g:
            assert json.load(f) == json.load(g), rel

    monkeypatch.setattr(jds, "_decode_frames", _frames)
    monkeypatch.setattr(tds, "_decode_frames", _frames)
    root = outs["port"]
    args = (str(root / "vidstg"), str(root / "videos"),
            str(root / "hc_ann" / "val_v2_proc.json"), str(root / "hc_videos"))
    want, got = _samples(jds, *args), _samples(tds, *args)
    assert len(got) == 6  # a question and a caption a VidSTG video, 2 + 2
    assert {s.qtype for s in got} == {"interrogative", "declarative", None}
    for w, g in zip(want, got):
        for field in ("video_id", "caption", "frame_ids", "inter_idx",
                      "img2box", "qtype"):
            assert getattr(w, field) == getattr(g, field), field
        np.testing.assert_array_equal(w.frames, g.frames)
        assert g.frames.shape == (len(g.frame_ids), 36, 64, 3)
        assert g.inter_idx and len(g.frame_ids) <= 100
    monkeypatch.undo()

    clip = np.random.default_rng(0).integers(0, 255, (12, 36, 64, 3),
                                             dtype=np.uint8)
    path = str(tmp_path / "clip.mp4")
    encode_video(path, clip, fps=25, codec="mpeg4")
    ids = [0, 3, 3, 11, 20, 7]
    got = tds._decode_frames(path, ids)
    assert got.shape == (6, 36, 64, 3)
    np.testing.assert_array_equal(got, jds._decode_frames(path, ids))
