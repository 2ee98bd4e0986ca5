"""Port parity: video decode and encode through the native library."""

import numpy as np

from video_llava_tpu.media import loader as jax_loader
from video_llava_tpu_torch.media import loader


def test_load_video_matches_jax_loader(tmp_path):
    """Byte-for-byte equal frames from both packages' load_video, for a
    clip longer than the 100-frame sample (uniform sampling) and one
    shorter (every frame the container reports is kept), encoded by
    either package."""
    rng = np.random.default_rng(0)
    long_path = str(tmp_path / "long.mp4")
    short_path = str(tmp_path / "short.mp4")
    jax_loader.encode_video(
        long_path, rng.integers(0, 256, size=(130, 48, 64, 3),
                                dtype=np.uint8), fps=24, codec="mpeg4")
    loader.encode_video(
        short_path, rng.integers(0, 256, size=(12, 48, 64, 3),
                                 dtype=np.uint8), fps=8, codec="mpeg4")
    for path in (long_path, short_path):
        want = jax_loader.load_video(path, shape=(56, 56))
        got = loader.load_video(path, shape=(56, 56))
        assert got.dtype == np.uint8 and got.shape[1:] == (56, 56, 3)
        np.testing.assert_array_equal(got, want)
    assert len(loader.load_video(long_path)) == 100


def test_get_seq_frames_matches_jax():
    from video_llava_tpu.ops.sampling import get_seq_frames as jax_seq
    from video_llava_tpu_torch.ops.sampling import get_seq_frames

    for total, want in ((1000, 100), (130, 100), (12, 12), (101, 100)):
        assert get_seq_frames(total, want) == jax_seq(total, want)
