"""Port parity: uniform frame sampling (ops.sampling)."""


def test_get_seq_frames_matches_jax():
    from video_llava_tpu.ops.sampling import get_seq_frames as jax_seq
    from video_llava_tpu_torch.ops.sampling import get_seq_frames

    for total, want in ((1000, 100), (130, 100), (12, 12), (101, 100)):
        assert get_seq_frames(total, want) == jax_seq(total, want)
