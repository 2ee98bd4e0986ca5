"""The port's Whisper decoding (models/whisper.py) against the JAX
package's on the same tiny f32 parameters and encoder states: the
cached decoder's logits teacher-forced on the JAX package's greedy
tokens (1e-4 absolute: f32 logits of order 1, other summation orders),
then the greedy tokens and lengths themselves (equal), the cached decode
against the port's own re-forward oracle, and decoder_forward."""

import numpy as np
import jax.numpy as jnp
import torch

from torch_audio_pair import whisper_pair
from video_llava_tpu.models import whisper as jwhisper
from video_llava_tpu_torch.models import whisper as twhisper

TOL = 1e-4
JCFG = jwhisper.WhisperConfig.tiny_test()
TCFG = twhisper.WhisperConfig.tiny_test()


def _enc(seed=0, b=2):
    return np.random.default_rng(seed).normal(
        size=(b, 40, JCFG.d_model)).astype(np.float32)


def _teacher_forced(tp, enc, start, toks):
    """The port's cached step over start + toks[:, :-1] (one chunk
    prefill, then a token a step): logits (b, s0 + n - 1, vocab)."""
    b, s0 = start.shape
    n = toks.shape[1]
    hd = TCFG.d_model // TCFG.num_heads
    xk, xv = twhisper.precompute_cross_kv(tp, enc, TCFG)
    shape = (TCFG.decoder_layers, b, s0 + n, TCFG.num_heads, hd)
    cache = twhisper.DecoderCache(torch.zeros(shape), torch.zeros(shape),
                                  xk, xv, torch.zeros(b, dtype=torch.int32))
    logits, cache = twhisper._decoder_step_cached(
        tp, start, torch.arange(s0).expand(b, s0), cache, TCFG)
    out = [logits]
    for i in range(n - 1):
        step, cache = twhisper._decoder_step_cached(
            tp, toks[:, i:i + 1], cache.length.long()[:, None], cache, TCFG)
        out.append(step)
    return torch.cat(out, dim=1)


def test_cached_decode_matches_jax():
    jp, tp = whisper_pair()
    enc = _enc()
    start = np.asarray([[1, 3], [1, 4]], np.int32)
    want_toks, want_lens = jwhisper.greedy_decode_cached(
        jp, jnp.asarray(enc), JCFG, jnp.asarray(start), 6, eot_token=0)
    want_toks = np.asarray(want_toks)
    # the JAX package's logits along its own greedy path
    seq = np.concatenate([start, want_toks], axis=1)
    want_logits = np.asarray(jwhisper.decoder_forward(
        jp, jnp.asarray(seq[:, :-1]), jnp.asarray(enc), JCFG))
    with torch.inference_mode():
        got_logits = _teacher_forced(tp, torch.from_numpy(enc),
                                     torch.from_numpy(start),
                                     torch.from_numpy(want_toks))
    np.testing.assert_allclose(got_logits.numpy(), want_logits, rtol=0,
                               atol=TOL)
    toks, lens = twhisper.greedy_decode_cached(
        tp, torch.from_numpy(enc), TCFG, torch.from_numpy(start), 6,
        eot_token=0)
    assert toks.dtype == torch.int32
    np.testing.assert_array_equal(toks.numpy(), want_toks)
    np.testing.assert_array_equal(lens.numpy(), np.asarray(want_lens))


def test_cached_matches_reforward_oracle():
    _, tp = whisper_pair()
    enc = torch.from_numpy(_enc(seed=1))
    start = torch.tensor([[1, 3], [1, 4]], dtype=torch.int32)
    want = twhisper.greedy_decode(tp, enc, TCFG, start, 6, eot_token=0)
    got = twhisper.greedy_decode_cached(tp, enc, TCFG, start, 6,
                                        eot_token=0)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_decode_stops_at_eot():
    """A row that emits eot is padded with eot after it and the loop
    ends when every row is done; lengths count the non-eot ids."""
    jp, tp = whisper_pair()
    enc = _enc(seed=2)
    start = np.asarray([[1, 3], [1, 4]], np.int32)
    first, _ = twhisper.greedy_decode_cached(
        tp, torch.from_numpy(enc), TCFG, torch.from_numpy(start), 3,
        eot_token=0)
    eot = int(first[0, 1])  # row 0's second token, as the eot id
    want = jwhisper.greedy_decode_cached(
        jp, jnp.asarray(enc), JCFG, jnp.asarray(start), 8, eot_token=eot)
    got = twhisper.greedy_decode_cached(
        tp, torch.from_numpy(enc), TCFG, torch.from_numpy(start), 8,
        eot_token=eot)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    n = int(got[1][0])
    assert n <= 1 and bool((got[0][0, n:] == eot).all())


def test_decoder_forward_matches_jax():
    jp, tp = whisper_pair()
    enc = _enc(seed=3)
    toks = np.random.default_rng(3).integers(0, 256, (2, 7)).astype(np.int32)
    want = jwhisper.decoder_forward(jp, jnp.asarray(toks), jnp.asarray(enc),
                                    JCFG)
    got = twhisper.decoder_forward(tp, torch.from_numpy(toks),
                                   torch.from_numpy(enc), TCFG)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)
