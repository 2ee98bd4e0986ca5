"""Port parity for the whole chat slice: tiny VideoLLaVA, the same
parameters and frames through both packages, from video file to answer.
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from torch_slice_pair import slice_pair  # noqa: F401 (fixture)
from video_llava_tpu.engine.generate import (
    generate_with_keywords as jax_generate_with_keywords,
)
from video_llava_tpu.models import video_llava as jax_vl
from video_llava_tpu.runtime.chat import (
    VideoChatGPTInterface as JaxInterface,
)
from video_llava_tpu_torch.engine.generate import generate_with_keywords
from video_llava_tpu_torch.media.loader import encode_video
from video_llava_tpu_torch.runtime.chat import VideoChatGPTInterface


def test_slice_matches_jax(slice_pair, tmp_path):
    """f32 params and caches. Prefill logits_last agree to 1e-4 (f32 in
    another summation order through CLIP, pooling, projector and 4
    decoder layers); greedy decoding -- two keyword-check chunks -- gives
    identical token ids and text; and the chat interface, fed a clip
    written by the native encoder, gives the JAX interface's answer."""
    jax_engine, engine = slice_pair
    cfg, tok = engine.cfg, engine.tokenizer
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, size=(9, 64, 64, 3), dtype=np.uint8)

    jfeats = jax_engine.encode_video_frames(frames, num_valid_frames=9)
    feats = engine.encode_video_frames(frames, num_valid_frames=9)
    np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats),
                               atol=1e-4, rtol=1e-4)

    prompt = "Describe the video.\n" + "<vid_start>" + (
        "<vid_patch>" * cfg.video_token_len) + "<vid_end>"
    input_ids, seq_lens, s_real = engine.padded_prompt(prompt)
    jids = jnp.asarray(input_ids.numpy().astype(np.int32))
    jlens = jnp.asarray([s_real], jnp.int32)

    want = jax_vl.prefill(jax_engine.params, cfg, jids, jlens,
                          jfeats[None], 256, cache_dtype=jnp.float32)
    got = engine.model.prefill(input_ids, seq_lens, feats[None], 256,
                               cache_dtype=torch.float32)
    np.testing.assert_allclose(got.logits_last.numpy(),
                               np.asarray(want.logits_last),
                               atol=1e-4, rtol=1e-4)

    decode = lambda t: tok.decode(t, skip_special_tokens=True)  # noqa: E731
    want_text, want_res = jax_generate_with_keywords(
        jax_engine.params, cfg, jax_engine.gen, jids, jlens, jfeats[None],
        jax.random.PRNGKey(0), decode_fn=decode, keyword_check_every=7,
        cache_dtype=jnp.float32,
    )
    got_text, got_res = generate_with_keywords(
        engine.model, engine.gen, input_ids, seq_lens, feats[None], None,
        decode_fn=decode, keyword_check_every=7, cache_dtype=torch.float32,
    )
    np.testing.assert_array_equal(got_res.tokens.numpy(),
                                  np.asarray(want_res.tokens))
    assert got_text == want_text

    path = str(tmp_path / "clip.mp4")
    encode_video(path, frames, fps=4, codec="mpeg4")
    answers = []
    for iface in (JaxInterface(jax_engine, temperature=0.0,
                               max_output_tokens=6),
                  VideoChatGPTInterface(engine, temperature=0.0,
                                        max_output_tokens=6)):
        iface.upload_video(path)
        iface.add_text("What is happening?", path)
        answers.append(iface.answer())
    assert answers[0] == answers[1]
