"""Device-side prefix-range top-k for autocomplete.

The reference walks a trie whose every node caches its top-10 candidates
(src/api_autocomplete.cpp:58-86,154-190). On the device, terms live in a
sorted table; a prefix maps to a contiguous index range [lo, hi) found by
binary search host-side, and the device ranks the range by score with a
masked top-k. Ties break toward the lower index — lexicographically smaller
term — matching the reference's (score desc, term asc) ordering
(src/api_autocomplete.cpp:48-51).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax


@functools.partial(jax.jit, static_argnames=("L",))
def prefix_range_topk(
    scores: jax.Array,  # int32 [T] term scores (summed df), sorted-term order
    lo: jax.Array,  # int32 [Q] range start per query
    hi: jax.Array,  # int32 [Q] range end per query
    *,
    L: int,
):
    """Top-L (score desc, index asc) within [lo, hi) per query.

    Returns (vals int32 [Q, L], idx int32 [Q, L]); slots past the range size
    carry val = -1 (scores are >= 1 for real terms). Scans the FULL table per
    query — the fallback for prefix ranges too wide for the windowed kernel.
    """
    T = scores.shape[0]
    idx = lax.broadcasted_iota(jnp.int32, (1, T), 1)
    mask = (idx >= lo[:, None]) & (idx < hi[:, None])
    masked = jnp.where(mask, scores[None, :], jnp.int32(-1))
    vals, pos = lax.top_k(masked, L)
    return vals, pos.astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("L", "W"))
def prefix_window_topk(
    scores: jax.Array,  # int32 [T]
    lo: jax.Array,  # int32 [Q]
    hi: jax.Array,  # int32 [Q] (hi - lo <= W)
    *,
    L: int,
    W: int,
):
    """Top-L within [lo, hi) via a gathered W-wide window per query.

    Work is Q*W instead of Q*T: at a realistic 500k-term vocabulary, long
    prefixes (the only ones not served by the per-prefix cache) cover narrow
    sorted-table ranges, so a small static window bounds the launch.
    """
    T = scores.shape[0]
    offs = lax.broadcasted_iota(jnp.int32, (1, W), 1)
    idx = lo[:, None] + offs  # [Q, W]
    valid = idx < hi[:, None]
    vals = jnp.where(valid, scores[jnp.clip(idx, 0, T - 1)], jnp.int32(-1))
    v, pos = lax.top_k(vals, min(L, W))
    out_idx = lo[:, None] + pos.astype(jnp.int32)
    if L > W:  # degenerate; pad (callers keep L <= 10)
        pad = ((0, 0), (0, L - W))
        v = jnp.pad(v, pad, constant_values=-1)
        out_idx = jnp.pad(out_idx, pad)
    return v, out_idx
