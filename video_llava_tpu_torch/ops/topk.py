"""Top-k in jax.lax.top_k's order.

jax.lax.top_k returns the k largest values of the last axis in
descending order, and of equal values the one at the lower index first.
torch.topk leaves the order of ties open, and the grounded path has ties
that matter: GroundingDINO's invalid two-stage proposals share one zeroed
query, and the STM memory holds the same key for a patch that did not
change between frames.
"""

from __future__ import annotations

import torch


def stable_topk(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries along the last axis,
    descending, ties broken toward the lower index (jax.lax.top_k)."""
    kth = torch.topk(x, k, dim=-1).values[..., -1:]
    greater = x > kth
    tie = x == kth
    need = k - greater.sum(-1, keepdim=True)
    # of the entries equal to the k-th value, the lowest-index `need`
    chosen = greater | (tie & (tie.cumsum(-1, dtype=torch.int32) <= need))
    idx = chosen.nonzero()[:, -1].reshape(x.shape[:-1] + (k,))
    vals = torch.gather(x, -1, idx)
    order = torch.sort(vals, dim=-1, descending=True, stable=True).indices
    return torch.gather(vals, -1, order), torch.gather(idx, -1, order)
