"""Batched BM25 scoring + fused top-k on device.

This replaces the reference's per-posting ifstream hot loop
(src/api_engine.cpp:441-496) with array programs over HBM-resident posting
arrays. BM25 per-posting contributions are precomputed at build time ("eager"
scoring, see index/builder.py), so query-time work is:

    gather posting windows -> weighted accumulate into per-doc scores -> top-k

Two execution modes:

  bm25_topk_exact   Term slots are accumulated sequentially (lax.fori over the
                    slot axis); within a slot each doc appears at most once, so
                    the f32 accumulation order equals the C++ engine's
                    term-at-a-time order — bit-exact score parity.

  bm25_topk_fast    All (slot, window) chunks are flattened into one scatter.
                    XLA is free to reorder the adds, so scores can differ from
                    the reference in the last ULP when several query terms hit
                    the same document; top-k sets are identical except on exact
                    float ties. Higher throughput: no sequential slot chain.

Both return (vals [Q,K] f32, idx [Q,K] int32 global doc slots, found [Q] int32)
where `found` counts matched docs (score>0), mirroring the reference's
total_found (src/api_engine.cpp:495). Padded/absent slots must be passed with
df=0 / weight=0. Ties break by lowest doc slot, the framework's canonical
(segment asc, docId asc) order (see index/oracle.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax


@functools.partial(jax.jit, static_argnames=("n_slots", "K", "block"))
def bm25_topk_exact(
    post_doc: jax.Array,  # int32 [P] global doc slot per posting
    post_score: jax.Array,  # f32 [P] eager BM25 contribution per posting
    starts: jax.Array,  # int32 [Q, T] posting offset per (query, term slot)
    dfs: jax.Array,  # int32 [Q, T] posting count per slot (0 = inactive)
    weights: jax.Array,  # f32 [Q, T] query weight per slot
    *,
    n_slots: int,
    K: int,
    block: int = 4096,
):
    Q, T = starts.shape
    P = post_doc.shape[0]
    offs = lax.broadcasted_iota(jnp.int32, (1, block), 1)  # [1, B]
    q_rows = lax.broadcasted_iota(jnp.int32, (Q, block), 0)  # [Q, B]

    def stage(t, scores):
        start = lax.dynamic_index_in_dim(starts, t, axis=1, keepdims=True)  # [Q,1]
        df = lax.dynamic_index_in_dim(dfs, t, axis=1, keepdims=True)
        w = lax.dynamic_index_in_dim(weights, t, axis=1, keepdims=True)
        max_df = jnp.max(df)
        n_windows = (max_df + block - 1) // block

        def window(wi, sc):
            o = offs + wi * block  # [1, B]
            valid = o < df  # [Q, B]
            idx = jnp.clip(start + o, 0, max(P - 1, 0))
            doc = jnp.where(valid, post_doc[idx], n_slots)  # OOB slot -> drop
            contrib = jnp.where(valid, w * post_score[idx], jnp.float32(0.0))
            return sc.at[q_rows, doc].add(contrib, mode="drop")

        return lax.fori_loop(0, n_windows, window, scores)

    scores = jnp.zeros((Q, n_slots), jnp.float32)
    scores = lax.fori_loop(0, T, stage, scores)
    vals, idx = lax.top_k(scores, K)
    found = jnp.sum(scores > 0, axis=1, dtype=jnp.int32)
    return vals, idx.astype(jnp.int32), found


@functools.partial(jax.jit, static_argnames=("n_slots", "K", "Q", "block"))
def bm25_topk_fast(
    post_doc: jax.Array,  # int32 [P]
    post_score: jax.Array,  # f32 [P]
    chunk_start: jax.Array,  # int32 [C] posting offset per chunk
    chunk_len: jax.Array,  # int32 [C] live postings in chunk (<= B)
    chunk_q: jax.Array,  # int32 [C] owning query row (Q = out of range -> drop)
    chunk_w: jax.Array,  # f32 [C] query weight for the chunk's term
    *,
    n_slots: int,
    K: int,
    Q: int,
    block: int = 4096,
):
    """Fused one-scatter variant over host-planned fixed-size chunks."""
    C = chunk_start.shape[0]
    P = post_doc.shape[0]
    offs = lax.broadcasted_iota(jnp.int32, (C, block), 1)
    valid = offs < chunk_len[:, None]
    idx = jnp.clip(chunk_start[:, None] + offs, 0, max(P - 1, 0))
    doc = jnp.where(valid, post_doc[idx], n_slots)
    contrib = jnp.where(valid, chunk_w[:, None] * post_score[idx], jnp.float32(0.0))

    scores = jnp.zeros((Q, n_slots), jnp.float32)
    qrow = jnp.broadcast_to(chunk_q[:, None], (C, block))
    scores = scores.at[qrow, doc].add(contrib, mode="drop")
    vals, idx_out = lax.top_k(scores, K)
    found = jnp.sum(scores > 0, axis=1, dtype=jnp.int32)
    return vals, idx_out.astype(jnp.int32), found


def expand_chunks(starts, dfs, weights, *, C, block):
    """Expand (query, term-slot) ranges into C fixed-size chunks ON DEVICE.

    Keeps per-batch host->device traffic to the [Q, T] plan arrays (~KBs);
    the chunk table (start, len, owning query, weight) is derived with a
    cumsum + searchsorted. The host picks C (a static bucket) from the same
    dfs, so no chunk is ever dropped. Slots with df=0 produce no chunks.
    """
    Q, T = starts.shape
    s_flat = starts.reshape(-1)
    df_flat = dfs.reshape(-1)
    w_flat = weights.reshape(-1)
    S = Q * T
    reps = (df_flat + (block - 1)) // block  # [S]
    cum = jnp.cumsum(reps)
    total = cum[-1]
    cidx = lax.broadcasted_iota(jnp.int32, (C, 1), 0)[:, 0]
    owner = jnp.searchsorted(cum, cidx, side="right").astype(jnp.int32)
    ownerc = jnp.clip(owner, 0, S - 1)
    within = cidx - (cum[ownerc] - reps[ownerc])
    live = cidx < total
    chunk_start = s_flat[ownerc] + within * block
    chunk_len = jnp.where(
        live, jnp.minimum(block, df_flat[ownerc] - within * block), 0
    )
    chunk_q = jnp.where(live, ownerc // T, Q)  # Q = out of range -> dropped
    chunk_w = w_flat[ownerc]
    return chunk_start, chunk_len, chunk_q.astype(jnp.int32), chunk_w


def scatter_scores(
    post_doc, post_score, chunk_start, chunk_len, chunk_q, chunk_w,
    *, Q, n_slots, block, dtype=jnp.float32,
):
    """Pass 1: fused scatter-add of all posting chunks -> dense [Q, n_slots].

    dtype=bfloat16 halves the dense-array traffic; approximate-score error is
    absorbed by the exact rescore pass, and `found` stays exact (no positive
    f32 contribution rounds to bf16 zero).
    """
    C = chunk_start.shape[0]
    P = post_doc.shape[0]
    offs = lax.broadcasted_iota(jnp.int32, (C, block), 1)
    valid = offs < chunk_len[:, None]
    idx = jnp.clip(chunk_start[:, None] + offs, 0, max(P - 1, 0))
    doc = jnp.where(valid, post_doc[idx], n_slots)
    contrib = jnp.where(valid, chunk_w[:, None] * post_score[idx], jnp.float32(0.0))
    scores = jnp.zeros((Q, n_slots), dtype)
    qrow = jnp.broadcast_to(chunk_q[:, None], (C, block))
    return scores.at[qrow, doc].add(contrib.astype(dtype), mode="drop")


def exact_rescore(
    post_doc, post_score, starts, dfs, weights, cand, *, bs_steps=24
):
    """Pass 2: bit-exact term-slot-order rescore of candidate doc slots.

    Vectorized lower_bound over each (query, term slot)'s doc-sorted posting
    range finds the candidate's posting; contributions accumulate in slot
    order, reproducing the C++ engine's f32 sum (src/api_engine.cpp:449-481).
    """
    Q, T = starts.shape
    k2 = cand.shape[1]
    P = post_doc.shape[0]
    s = starts[:, :, None].astype(jnp.int32)
    d = dfs[:, :, None]
    w = weights[:, :, None]
    c = cand[:, None, :]
    lo = jnp.zeros((Q, T, k2), jnp.int32)
    hi = jnp.broadcast_to(d, (Q, T, k2))

    def bs_step(_i, state):
        lo, hi = state
        mid = (lo + hi) // 2
        v = post_doc[jnp.clip(s + mid, 0, max(P - 1, 0))]
        go_right = v < c  # lower_bound: advance lo past smaller docs
        return (jnp.where(go_right, mid + 1, lo), jnp.where(go_right, hi, mid))

    lo, hi = lax.fori_loop(0, bs_steps, bs_step, (lo, hi))
    pos = jnp.clip(s + lo, 0, max(P - 1, 0))
    hit = (lo < d) & (post_doc[pos] == c) & (w != 0.0)
    term_contrib = jnp.where(hit, w * post_score[pos], jnp.float32(0.0))

    def acc_step(t, acc):
        return acc + lax.dynamic_index_in_dim(term_contrib, t, axis=1, keepdims=False)

    return lax.fori_loop(0, T, acc_step, jnp.zeros((Q, k2), jnp.float32))


def heavy_scores(dense_rows, unique_rows, mix, dtype=jnp.float32):
    """Dense-row contribution: gather unique heavy rows, one matmul.

    dense_rows [H+1, n_slots] f32 or bf16 (row H is all-zero padding),
    unique_rows int32 [U], mix f32 [Q, U] (summed query weights per unique
    row). Returns [Q, n_slots] in `dtype`; accumulation is f32.
    bf16 rows halve HBM residency and matmul read traffic; approximation is
    absorbed by the exact rescore, and positives stay positive so `found`
    stays exact.
    """
    d_sub = dense_rows[unique_rows]  # [U, n_slots] contiguous row gather
    out = jnp.dot(
        mix.astype(d_sub.dtype), d_sub, preferred_element_type=jnp.float32
    )
    return out.astype(dtype)


def tiled_topk(scores, k2: int, tile: int = 2048):
    """Exact top-k2 over a wide doc axis via tile-max prefiltering.

    If a doc is in the true top-k2, its tile's max is >= the doc's score, so
    fewer than k2 tiles can beat it outright — the doc's tile is always among
    the top-k2 tiles by max. Gathering those tiles and running top_k inside
    them is therefore EXACT while scanning k2*tile instead of n_slots
    elements (15x less at 1M docs). Returns (vals, doc_slots).
    """
    Q, NS = scores.shape
    if NS % tile != 0 or NS <= k2 * tile:
        vals, idx = lax.top_k(scores, k2)
        return vals, idx.astype(jnp.int32)
    n_tiles = NS // tile
    tiles = scores.reshape(Q, n_tiles, tile)
    tile_max = jnp.max(tiles, axis=2)  # [Q, n_tiles]
    _tv, tidx = lax.top_k(tile_max, k2)  # [Q, k2]
    # slot-ascending tile order keeps the canonical (doc asc) tie-break of
    # the flat top_k below
    tidx = jnp.sort(tidx, axis=1)
    cand_tiles = jnp.take_along_axis(tiles, tidx[:, :, None], axis=1)
    flat = cand_tiles.reshape(Q, k2 * tile)
    vals, pos = lax.top_k(flat, k2)
    # map positions back to global doc slots
    which_tile = pos // tile
    base = jnp.take_along_axis(tidx, which_tile, axis=1) * tile
    return vals, (base + pos % tile).astype(jnp.int32)


def canonical_sort(scores, docs):
    """Order candidates by (score desc, doc slot asc); dead slots last."""
    neg = jnp.where(scores > 0, -scores, jnp.float32(jnp.inf))
    sdoc = jnp.where(scores > 0, docs, jnp.int32(2**30))
    _k, out_doc, out_val = lax.sort((neg, sdoc, scores), num_keys=2)
    return out_val, out_doc


@functools.partial(
    jax.jit, static_argnames=("n_slots", "K", "K2", "C", "block", "bs_steps")
)
def bm25_topk_fused(
    post_doc: jax.Array,  # int32 [P]
    post_score: jax.Array,  # f32 [P]
    dense_rows: jax.Array,  # f32 [H+1, n_slots] (row H = zero padding)
    starts: jax.Array,  # int32 [Q, T] ALL term slots (rescore)
    dfs: jax.Array,  # int32 [Q, T] ALL term slots (rescore)
    weights: jax.Array,  # f32 [Q, T]
    light_dfs: jax.Array,  # int32 [Q, T] dfs with heavy slots zeroed (scatter)
    unique_heavy: jax.Array,  # int32 [U] unique dense-row ids this batch
    heavy_mix: jax.Array,  # f32 [Q, U] summed weights per unique heavy row
    *,
    n_slots: int,
    K: int,
    K2: int,
    C: int,
    block: int = 2048,
    bs_steps: int = 24,
):
    """Single-launch BM25 top-k: fused scatter + exact candidate rescore.

    Pass 1 accumulates all (query, term) posting chunks in ONE scatter-add
    into dense per-query scores — ~1000x faster than per-term sequential
    scatters, but XLA may reorder the f32 adds. Pass 2 therefore exactly
    rescores the top-K2 candidates: a vectorized binary search finds each
    (term slot, candidate) posting, and contributions are re-accumulated in
    term-slot order (the C++ engine's order, src/api_engine.cpp:449-481), so
    reported scores are bit-exact. Candidates are finally re-ranked by
    (exact score desc, doc slot asc) — the framework's canonical tie order.

    `found` (matched-doc count) is exact in any order: contributions are all
    positive, so the scatter result is > 0 iff the doc matched.

    K2 > K guards the candidate boundary against ULP-level reordering in
    pass 1. Returns (vals f32 [Q, K], idx int32 [Q, K], found int32 [Q]).
    """
    Q, T = starts.shape
    chunk_start, chunk_len, chunk_q, chunk_w = expand_chunks(
        starts, light_dfs, weights, C=C, block=block
    )
    scores = scatter_scores(
        post_doc, post_score, chunk_start, chunk_len, chunk_q, chunk_w,
        Q=Q, n_slots=n_slots, block=block,
    )
    scores = scores + heavy_scores(dense_rows, unique_heavy, heavy_mix)
    found = jnp.sum(scores > 0, axis=1, dtype=jnp.int32)
    k2 = min(K2, n_slots)
    _fvals, cand = tiled_topk(scores, k2)  # cand: [Q, k2] doc slots
    exact = exact_rescore(
        post_doc, post_score, starts, dfs, weights, cand, bs_steps=bs_steps
    )
    sval, sdoc = canonical_sort(exact, cand)
    return sval[:, :K], sdoc[:, :K].astype(jnp.int32), found


@functools.partial(
    jax.jit,
    static_argnames=("n_slots", "K", "K2", "C", "block", "bs_steps", "scores_bf16"),
)
def bm25_search_packed(
    post_doc: jax.Array,  # int32 [P]
    post_score: jax.Array,  # f32 [P]
    dense_rows: jax.Array,  # f32 [H+1, n_slots]
    plan_ints: jax.Array,  # int32 [3, Q, T]: starts / dfs / light_dfs
    plan_f32: jax.Array,  # f32 [Q+1, T+U]: [weights | heavy_mix] rows; the
    #                       last row's U columns hold unique_heavy ids as
    #                       exact f32 VALUES (ids < 2^24; bit-packing would
    #                       produce denormals a device may flush to zero)
    *,
    n_slots: int,
    K: int,
    K2: int,
    C: int,
    block: int = 2048,
    bs_steps: int = 24,
    scores_bf16: bool = False,
):
    """Transfer-minimal variant of bm25_topk_fused.

    Every host<->device array costs a transfer of its own, so the
    query plan rides in TWO arrays and the result in ONE packed f32
    [Q, 2K+1]: columns [vals(K) | idx(K) | found(1)] as exact f32 values.
    scores_bf16 halves the dense score-array traffic (reported scores stay
    bit-exact via the f32 rescore; found stays exact).
    """
    starts = plan_ints[0]
    dfs = plan_ints[1]
    light_dfs = plan_ints[2]
    Q, T = starts.shape
    U = plan_f32.shape[1] - T
    weights = plan_f32[:Q, :T]
    heavy_mix = plan_f32[:Q, T:]
    unique_heavy = plan_f32[Q, T:].astype(jnp.int32)
    sdtype = jnp.bfloat16 if scores_bf16 else jnp.float32

    chunk_start, chunk_len, chunk_q, chunk_w = expand_chunks(
        starts, light_dfs, weights, C=C, block=block
    )
    scores = scatter_scores(
        post_doc, post_score, chunk_start, chunk_len, chunk_q, chunk_w,
        Q=Q, n_slots=n_slots, block=block, dtype=sdtype,
    )
    scores = scores + heavy_scores(dense_rows, unique_heavy, heavy_mix, dtype=sdtype)
    found = jnp.sum(scores > 0, axis=1, dtype=jnp.int32)
    k2 = min(K2, n_slots)
    _fv, cand = tiled_topk(scores, k2)
    exact = exact_rescore(
        post_doc, post_score, starts, dfs, weights, cand.astype(jnp.int32),
        bs_steps=bs_steps,
    )
    sval, sdoc = canonical_sort(exact, cand.astype(jnp.int32))
    # Pack ints as exact f32 VALUES (doc slots / found < 2^24), NOT bitcasts:
    # small int32 bit patterns are f32 denormals, which a device may flush
    # to zero in transit.
    out = jnp.concatenate(
        [
            sval[:, :K],
            sdoc[:, :K].astype(jnp.float32),
            found[:, None].astype(jnp.float32),
        ],
        axis=1,
    )
    return out


def score_only_exact(post_doc, post_score, starts, dfs, weights, *, n_slots, block=4096):
    """Exact-mode dense scores [Q, n_slots] without top-k (shard-local use)."""
    Q, T = starts.shape
    P = post_doc.shape[0]
    offs = lax.broadcasted_iota(jnp.int32, (1, block), 1)
    q_rows = lax.broadcasted_iota(jnp.int32, (Q, block), 0)

    def stage(t, scores):
        start = lax.dynamic_index_in_dim(starts, t, axis=1, keepdims=True)
        df = lax.dynamic_index_in_dim(dfs, t, axis=1, keepdims=True)
        w = lax.dynamic_index_in_dim(weights, t, axis=1, keepdims=True)
        n_windows = (jnp.max(df) + block - 1) // block

        def window(wi, sc):
            o = offs + wi * block
            valid = o < df
            idx = jnp.clip(start + o, 0, max(P - 1, 0))
            doc = jnp.where(valid, post_doc[idx], n_slots)
            contrib = jnp.where(valid, w * post_score[idx], jnp.float32(0.0))
            return sc.at[q_rows, doc].add(contrib, mode="drop")

        return lax.fori_loop(0, n_windows, window, scores)

    scores = jnp.zeros((Q, n_slots), jnp.float32)
    return lax.fori_loop(0, T, stage, scores)
