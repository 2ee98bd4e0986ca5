"""Port parity: the training data pipeline (train/data.py: the
conversation templating and label masking, feature loading, bucketed
collation) against the JAX package's on the same JSON and feature
files, with the byte tokenizer."""

import json
import pickle

import numpy as np

from video_llava_tpu.runtime import conversation as jconv
from video_llava_tpu.runtime.tokenizer import ByteTokenizer as JaxByteTokenizer
from video_llava_tpu.train import data as jdata
from video_llava_tpu_torch.runtime import conversation as tconv
from video_llava_tpu_torch.runtime.tokenizer import ByteTokenizer
from video_llava_tpu_torch.train import data as tdata

VIDEO_TOKEN_LEN = 16


def _write_samples(tmp_path):
    """Five samples: features as .npy, .pkl and .npz (named with and
    without extension), two rounds in one, a long answer that the
    600-token cap truncates, and one without video."""
    rng = np.random.default_rng(0)
    folder = tmp_path / "feats"
    folder.mkdir()
    feats = {f"v{i}": rng.standard_normal((VIDEO_TOKEN_LEN, 8)).astype(
        np.float32) for i in range(4)}
    np.save(folder / "v0.npy", feats["v0"])
    with open(folder / "v1.pkl", "wb") as f:
        pickle.dump(feats["v1"].astype(np.float64), f)
    np.savez(folder / "v2.npz", features=feats["v2"])
    np.save(folder / "v3.npy", feats["v3"])

    def turn(q, a):
        return [{"from": "human", "value": q}, {"from": "gpt", "value": a}]

    samples = [
        {"video": "v0", "conversations": turn(
            "<video>\nWhat happens?", "A man walks a dog.")},
        {"video": "v1", "conversations": turn(
            "Describe it.\n<video>", "Rain falls on a red car.")
            + turn("And then?", "It drives away slowly.")},
        {"video": "v2.npz", "conversations": turn(
            "<video>\nSummarise.", "Crowds cheer. " * 3)},
        {"video": "v3.npy", "conversations": turn(
            "<video>\nLong answer?", "word " * 200)},
        {"conversations": turn("Hello?", "Hi there.")},
    ]
    path = tmp_path / "data.json"
    path.write_text(json.dumps(samples))
    return str(path), str(folder)


def test_dataset_and_collator_match_jax(tmp_path, monkeypatch):
    """For the default template (conv_v1_2, SINGLE: preprocess_default)
    and Vicuna v1.1 (TWO: preprocess_v1): every sample's input_ids,
    labels and features are equal, and so are the collated batches (the
    128-token bucket, capped at max_len 600), the shuffled epoch order
    of data_iterator included."""
    data_path, folder = _write_samples(tmp_path)
    for template in ("default", "vicuna_v1_1"):
        if template != "default":
            monkeypatch.setattr(jconv, "default_conversation",
                                jconv.conv_templates[template])
            monkeypatch.setattr(tconv, "default_conversation",
                                tconv.conv_templates[template])
        datasets = []
        for mod, tok in ((jdata, JaxByteTokenizer()), (tdata, ByteTokenizer())):
            cfg = mod.MultimodalCfg(video_token_len=VIDEO_TOKEN_LEN,
                                    video_folder=folder)
            datasets.append(mod.LazySupervisedDataset(data_path, tok, cfg,
                                                      max_len=600))
        jd, td = datasets
        assert len(td) == len(jd) == 5
        targets = 0
        for i in range(5):
            want, got = jd[i], td[i]
            assert sorted(got) == sorted(want), i
            for key in want:
                assert got[key].dtype == want[key].dtype, (template, i, key)
                np.testing.assert_array_equal(got[key], want[key],
                                              err_msg=f"{template} {i} {key}")
            targets += int((got["labels"] != tdata.IGNORE_INDEX).sum())
        assert targets > 0 and len(td[3]["input_ids"]) == 600

        pad = ByteTokenizer().pad_token_id
        jc = jdata.Collator(pad, max_len=600)
        tc = tdata.Collator(pad, max_len=600)
        for rows in ([0, 1, 2], [0, 3], [4]):
            want = jc([jd[i] for i in rows])
            got = tc([td[i] for i in rows])
            assert sorted(got) == sorted(want)
            for key in want:
                np.testing.assert_array_equal(got[key], want[key])
        assert tc([td[0], td[3]])["input_ids"].shape == (2, 600)
        epochs = [list(mod.data_iterator(d, c, 2, np.random.default_rng(1)))
                  for mod, d, c in ((jdata, jd, jc), (tdata, td, tc))]
        assert len(epochs[0]) == len(epochs[1]) == 2
        for want, got in zip(*epochs):
            for key in want:
                np.testing.assert_array_equal(got[key], want[key])
