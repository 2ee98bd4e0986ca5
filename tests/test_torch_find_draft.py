"""Port parity: the prompt-lookup draft search, exact against JAX."""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from video_llava_tpu.engine.speculative import find_draft as jax_find_draft
from video_llava_tpu_torch.engine.speculative import find_draft


def test_find_draft_matches_jax_exactly():
    """Batched lookup against the JAX package's find_draft (vmapped over
    the rows) on contexts drawn from a 3-token alphabet (many matches,
    most recent wins), with lengths from 0 to the buffer's end (short
    contexts; a continuation clipped to the known context; a start past
    C - k, where both slices clamp), for ngram 1-3 and k 1-8. Drafts
    and lengths equal, element for element."""
    rng = np.random.default_rng(0)
    cases = 0
    for ngram, k in ((1, 1), (2, 4), (3, 8), (2, 8), (3, 3)):
        c = 24
        ctx = rng.integers(0, 3, size=(16, c)).astype(np.int32)
        ctx_len = np.concatenate([[0, 1, ngram, ngram + 1, c - 1, c],
                                  rng.integers(0, c + 1, size=10)])
        ctx_len = ctx_len.astype(np.int32)
        want_d, want_n = jax.vmap(
            lambda row, n: jax_find_draft(row, n, ngram, k))(
                jnp.asarray(ctx), jnp.asarray(ctx_len))
        got_d, got_n = find_draft(torch.from_numpy(ctx),
                                  torch.from_numpy(ctx_len), ngram, k)
        np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
        np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
        cases += int((np.asarray(want_n) > 0).sum())
    assert cases > 20  # most rows found a draft
