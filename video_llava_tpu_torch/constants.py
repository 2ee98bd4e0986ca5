"""Special tokens and limits, the same values as
video_llava_tpu/constants.py (tests/test_torch_config_parity.py holds
them equal)."""

DEFAULT_VIDEO_TOKEN = "<video>"
DEFAULT_VIDEO_PATCH_TOKEN = "<vid_patch>"
DEFAULT_VID_START_TOKEN = "<vid_start>"
DEFAULT_VID_END_TOKEN = "<vid_end>"
DEFAULT_TRANSCRIPT_START = "The noisy audio transcript of this video is:"

# Videos of any length are mean-pooled to at most this many temporal
# tokens, zero-padded up to it.
MAX_TEMPORAL_TOKENS = 100
