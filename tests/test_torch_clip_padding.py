"""Port: the CLIP tower's once-padded sequence length."""

from video_llava_tpu_torch.models.clip import padded_length


def test_padded_length_rule():
    """257 -> 272 at 224 px and 577 -> 640 at 336 px."""
    assert padded_length(257) == 272
    assert padded_length(577) == 640
    assert padded_length(17) == 32
