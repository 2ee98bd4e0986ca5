"""Port parity for the whole chat slice: tiny VideoLLaVA, the same
parameters and frames through both packages, from video file to answer.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from video_llava_tpu.config import (
    GenerationConfig,
    LlamaConfig,
    VideoLLaVAConfig,
)
from video_llava_tpu.engine.generate import generate as jax_generate
from video_llava_tpu.engine.generate import (
    generate_with_keywords as jax_generate_with_keywords,
)
from video_llava_tpu.models import video_llava as jax_vl
from video_llava_tpu.runtime.chat import (
    VideoChatGPTInterface as JaxInterface,
)
from video_llava_tpu.runtime.inference import (
    InferenceEngine as JaxEngine,
)
from video_llava_tpu.runtime.tokenizer import ByteTokenizer
from video_llava_tpu_torch.engine.convert import params_from_jax
from video_llava_tpu_torch.engine.generate import (
    generate,
    generate_with_keywords,
)
from video_llava_tpu_torch.media.loader import encode_video
from video_llava_tpu_torch.runtime.chat import VideoChatGPTInterface
from video_llava_tpu_torch.runtime.inference import InferenceEngine


@pytest.fixture(scope="module")
def slice_pair():
    tok = ByteTokenizer()
    cfg = dataclasses.replace(
        VideoLLaVAConfig.tiny(),
        llm=LlamaConfig.tiny(vocab_size=512),  # most ids decode to bytes
        vid_patch_token_id=tok.vid_patch_token_id,
        vid_start_token_id=tok.vid_start_token_id,
        vid_end_token_id=tok.vid_end_token_id,
    )
    params = jax_vl.init_params(jax.random.PRNGKey(0), cfg, jnp.float32)
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg)
    gen = GenerationConfig(max_new_tokens=12, do_sample=False,
                           eos_token_id=tok.eos_token_id,
                           pad_token_id=tok.pad_token_id)
    jax_engine = JaxEngine(params=params, cfg=cfg, tokenizer=tok, gen=gen,
                           seq_pad_multiple=64, cache_dtype=jnp.float32,
                           speculative=False)
    engine = InferenceEngine(model=model, cfg=cfg, tokenizer=tok, gen=gen,
                             seq_pad_multiple=64,
                             cache_dtype=torch.float32)
    return jax_engine, engine


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


def test_chat_second_turn_matches_jax(slice_pair, tmp_path):
    """A second turn reuses the uploaded video and the history."""
    jax_engine, engine = slice_pair
    rng = np.random.default_rng(1)
    path = str(tmp_path / "clip.mp4")
    encode_video(path, rng.integers(0, 256, size=(5, 64, 64, 3),
                                    dtype=np.uint8), fps=4, codec="mpeg4")
    answers = []
    for iface in (JaxInterface(jax_engine, temperature=0.0,
                               max_output_tokens=5),
                  VideoChatGPTInterface(engine, temperature=0.0,
                                        max_output_tokens=5)):
        iface.upload_video(path)
        iface.add_text("What is happening?", path)
        first = iface.answer()
        iface.add_text("And then?", path)
        answers.append((first, iface.answer(), iface.state.get_prompt()))
    assert answers[0] == answers[1]


def test_generate_batch_with_stops_matches_jax(slice_pair):
    """Batch 2, ragged prompts, greedy, with a stop id that ends one row
    early: identical tokens (pad after the stop), lengths, and the
    finished row's cache length frozen at its stop."""
    jax_engine, engine = slice_pair
    cfg = engine.cfg
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 256, size=(2, 160)).astype(np.int64)
    ids[:, 4:4 + cfg.video_token_len] = cfg.vid_patch_token_id
    lens = np.array([160, 131], np.int32)
    frames = rng.integers(0, 256, size=(2, 6, 64, 64, 3), dtype=np.uint8)
    jfeats = jnp.stack([jax_engine.encode_video_frames(f) for f in frames])
    feats = torch.stack([engine.encode_video_frames(f) for f in frames])

    def run(gen):
        want = jax_generate(jax_engine.params, cfg, gen,
                            jnp.asarray(ids.astype(np.int32)),
                            jnp.asarray(lens), jfeats,
                            jax.random.PRNGKey(0), cache_dtype=jnp.float32)
        got = generate(engine.model, gen, torch.from_numpy(ids),
                       torch.from_numpy(lens), feats,
                       cache_dtype=torch.float32)
        np.testing.assert_array_equal(got.tokens.numpy(),
                                      np.asarray(want.tokens))
        np.testing.assert_array_equal(got.lengths.numpy(),
                                      np.asarray(want.lengths))
        np.testing.assert_array_equal(got.cache.length.numpy(),
                                      np.asarray(want.cache.length))
        return got

    gen = dataclasses.replace(jax_engine.gen, max_new_tokens=6)
    free = run(gen)
    stop = int(free.tokens[0, 2])
    stopped = run(dataclasses.replace(gen, stop_token_ids=(stop,)))
    assert int(stopped.lengths[0]) <= 3 < 6


def test_infer_matches_jax(slice_pair):
    """The single-shot InferenceEngine.infer flow, greedy."""
    jax_engine, engine = slice_pair
    frames = np.random.default_rng(3).integers(
        0, 256, size=(4, 64, 64, 3), dtype=np.uint8)
    want = jax_engine.infer(frames, "What is shown?")
    assert engine.infer(frames, "What is shown?") == want


def test_process_logits_matches_jax():
    """Temperature + top-p masking: the same kept set and values."""
    from video_llava_tpu.engine.generate import process_logits as jax_pl
    from video_llava_tpu_torch.engine.generate import process_logits

    logits = np.random.default_rng(4).normal(size=(3, 50)).astype(np.float32)
    gen = GenerationConfig(temperature=0.5, top_p=0.7)
    want = np.asarray(jax_pl(jnp.asarray(logits), gen))
    got = process_logits(torch.from_numpy(logits), gen).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got[~np.isinf(got)], want[~np.isinf(want)],
                               rtol=1e-6)
