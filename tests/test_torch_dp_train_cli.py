"""The training entry point sharded: python -m
video_llava_tpu_torch.train.train --mesh_data 2 --mesh_model 2
--dist_backend gloo --device cpu (4 ranks spawned by the first) at the
tiny size (a bf16 model) against train.main in one process on the same
data, seed and global batch (4 rows: 2 a data rank):

  * the summary's per-step losses within 2^-8 relative and grad norms
    within 2^-6 (bf16 weights and activations: the sharded products and
    sums round in another order, each data rank pads its rows to its own
    bucket, and after the first update the bf16 weights themselves part
    by a rounding here and there, which the gradient's norm feels most),
    the global token count and the mesh recorded, and one
    train_summary.json (the first rank's);
  * the 2 x 2 run's projector export (projector and embed_tokens) next
    to one process's: on average within 5% of one step's size lr, and no
    element further apart than 2 lr a step. Adam moves each element by
    about lr times its gradient's sign, and a bf16 gradient element that
    nearly cancels (each data rank's partial rounded to bf16 before the
    ranks add them) can take either sign: 0.7% of the projector's
    elements part by more than two bf16 ulps, by 3 lr at most, 1% of lr
    on average;
  * its checkpoint (the one-process format, written by the first rank)
    resumes in one process, and one process's resumes on the 2 x 2 mesh:
    the next steps' losses equal those of one process resuming its own
    checkpoint, within the same limit."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

from test_torch_train_cli import _write_data
from video_llava_tpu_torch.train import train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = ["--mesh_data", "2", "--mesh_model", "2", "--dist_backend", "gloo"]


def _sharded(argv):
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK")}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-m", "video_llava_tpu_torch.train.train", *argv,
         *MESH], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


def _summary(out):
    with open(os.path.join(out, "train_summary.json")) as f:
        return json.load(f)


def _close_steps(got, want):
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=2 ** -8)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=2 ** -6)


def test_sharded_cli_matches_one_process_and_resumes_across(tmp_path):
    data, feats = _write_data(tmp_path)
    base = ["--data_path", data, "--video_folder", feats,
            "--model_size", "tiny", "--device", "cpu",
            "--num_train_epochs", "1", "--save_steps", "2",
            "--warmup_ratio", "0.25", "--learning_rate", "2e-3"]
    one, four = str(tmp_path / "one"), str(tmp_path / "four")

    want = train.main(base + ["--output_dir", one,
                              "--per_device_train_batch_size", "4"])
    stdout = _sharded(base + ["--output_dir", four,
                              "--per_device_train_batch_size", "2"])
    assert stdout.count("training complete") == 1  # the first rank's
    got = _summary(four)
    assert got["mesh"] == [2, 2] and got["steps"] == want["steps"] == 2
    assert got["tokens"] == want["tokens"]
    _close_steps(got, want)
    assert sorted(os.listdir(four)) == ["checkpoint-2", "mm_projector",
                                        "mm_projector.bin",
                                        "train_summary.json"]

    a = torch.load(os.path.join(four, "mm_projector.bin"))
    b = torch.load(os.path.join(one, "mm_projector.bin"))
    assert sorted(a) == sorted(b)
    lr, steps = 2e-3, 2
    for k in a:
        diff = np.abs(a[k].numpy() - b[k].numpy())
        assert diff.mean() <= 0.05 * lr, (k, diff.mean())
        assert diff.max() <= 2 * lr * steps, (k, diff.max())

    # resume across layouts: each copy takes steps 3 and 4
    runs = {}
    for name, src in (("one_from_one", one), ("one_from_four", four),
                      ("four_from_one", one)):
        dst = str(tmp_path / name)
        os.makedirs(dst)
        shutil.copytree(os.path.join(src, "checkpoint-2"),
                        os.path.join(dst, "checkpoint-2"))
        argv = base + ["--output_dir", dst]
        if name.startswith("four"):
            assert "resuming from" in _sharded(
                argv + ["--per_device_train_batch_size", "2"])
            runs[name] = _summary(dst)
        else:
            runs[name] = train.main(argv + ["--per_device_train_batch_size",
                                            "4"])
        assert runs[name]["steps"] == 4
    _close_steps(runs["one_from_four"], runs["one_from_one"])
    _close_steps(runs["four_from_one"], runs["one_from_one"])
