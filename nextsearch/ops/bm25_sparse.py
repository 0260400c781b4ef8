"""Sparse-light BM25 execution: no dense scatter, no full-matrix re-reads.

The fused-scatter design (ops/bm25.py) scatter-adds every posting into a
[Q, n_slots] score matrix and then re-reads that matrix for the matched-doc
count and the per-tile max. This module replaces the scatter pipeline
(reference hot loop: src/api_engine.cpp:469-496) with:

  heavy terms   one matrix product H = mix @ dense_rows plus per-sub-tile
                maxima and per-tile hit counts (ops/heavy.py)
  light terms   posting windows expanded on device, then sort by (q, doc) +
                segmented f32 sum in term-slot order -> per-(q, doc) totals
                (stable sort keeps the C++ accumulation order within a doc)
  found         heavy hit counts + light-only docs (H == 0 at the light
                doc), both exact at ANY matmul precision (all operands
                positive, no cancellation)
  candidates    top-K2 heavy docs from sub-tile maxima UNION top-K2 light
                docs by (light total + H); the default guarded fast path
                merges the two pools into ONE K2-wide set and PROVES per
                query that the narrowing and the TF32 matmul could not
                change the top-K (else the caller relaunches the exact
                wide-pool kernel — see _packed_impl's fast_heavy docs)
  rescore       bit-exact f32 re-accumulation in term-slot order: heavy
                slots read their exact eager score straight off the f32
                dense rows (exact_rescore_v4/v5); light slots run a bucket-
                narrowed lower_bound over their posting range. The device
                only does fixed-order f32 add/mul on host-precomputed
                scores, so parity is portable across backends.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
from jax import lax

from .bm25 import canonical_sort, expand_chunks
from .heavy import CSUB, heavy_fused3_xla

def _segmented_cumsum(vals, first):
    """Inclusive segmented cumsum: resets at each True in `first`."""

    def op(a, b):
        va, fa = a
        vb, fb = b
        return jnp.where(fb, vb, va + vb), fa | fb

    out, _ = lax.associative_scan(op, (vals, first))
    return out


def _shift1(x, fill):
    return jnp.concatenate([jnp.full((1,), fill, x.dtype), x[:-1]])


def _segmented_cumsum_bounded(vals, first, tmax: int):
    """Inclusive segmented cumsum for segments of length <= tmax, in exact
    serial (left-fold) order.

    light_totals' (q, doc) groups hold at most one lane per term slot, so
    their length is bounded by the envelope's static T — a tmax-1-step
    shifted-add chain replaces lax.associative_scan's ~log2(N) levels of
    tuple select/add. s_k[i] = s_{k-1}[i-1] + vals[i] is the
    LEFT FOLD of the k+1 trailing lanes, so out[i] = s_{o[i]}[i] (o = lane
    offset within its segment) accumulates in exact lane order — the
    stable sort's term-slot order, i.e. the reference's accumulation order
    (src/api_engine.cpp:473-481) — where the associative scan's balanced
    tree reassociates groups of 4+. Lanes deeper than tmax into a segment
    (only the invalid-padding sentinel group at the stream tail; live
    groups cannot exceed T) return the tmax-lane left fold instead of the
    full sum: callers mask those lanes out (light_totals' valid_last).
    """
    out = vals
    s = vals
    m = ~first  # m_k[i]: lane i is >= k lanes into its segment (k = 1 here)
    for _ in range(max(tmax - 1, 0)):
        s = _shift1(s, 0) + vals
        out = jnp.where(m, s, out)
        m = m & _shift1(m, False)
    return out


def _cumsum_count_blocked(ind):
    """Inclusive cumsum of a flat 0/1 indicator via 128-lane triangular
    matmuls + a short carry scan.

    Block form: one [N/128, 128] x [128, 128] upper-triangular dot gives
    every in-block prefix (0/1 operands are exact in bf16 and TF32 and the
    accumulation is f32, so the product is exact at any dot precision), and
    only the [N/128] block totals ride a full-length scan.
    f32 holds counts exactly to 2^24 — far above any flat stream here.
    Returns int32.
    """
    n = ind.shape[0]
    x = ind.astype(jnp.float32)
    if n < 1024 or n % 128 != 0:
        return jnp.cumsum(ind.astype(jnp.int32))
    nb = n // 128
    xb = x.reshape(nb, 128)
    io = lax.broadcasted_iota(jnp.int32, (128, 128), 0)
    jo = lax.broadcasted_iota(jnp.int32, (128, 128), 1)
    tri = (io <= jo).astype(jnp.float32)  # tri[k, j] = 1 for k <= j
    inner = jnp.dot(
        xb, tri, preferred_element_type=jnp.float32,
        precision=lax.Precision.DEFAULT,
    )  # [nb, 128] in-block inclusive prefixes
    carry = jnp.cumsum(inner[:, -1]) - inner[:, -1]  # exclusive block sums
    return (inner + carry[:, None]).astype(jnp.int32).reshape(n)


def light_totals(post_doc, post_score, starts, light_dfs, weights, *, C, block, Q, n_slots,
                 skip_sort: bool = False, skip_segsum: bool = False):
    """Flat per-(query, doc) light-term totals via sort + segmented sum.

    Returns (sq, sd, stot, last) sorted by (q, doc): stot at `last` positions
    is the f32 sum of that (q, doc)'s light contributions accumulated in
    term-slot order (stable sort preserves expansion order within a group).
    Invalid/padding entries carry q = Q and sort to the end.

    skip_sort (static, profiling only — results are WRONG) keeps the
    expansion/segsum work but drops the flat (q, doc) sort so
    a profiling harness can attribute the sort's marginal cost
    within the light chain.
    """
    cs, cl, cq, cw = expand_chunks(starts, light_dfs, weights, C=C, block=block)
    P = post_doc.shape[0]
    offs = lax.broadcasted_iota(jnp.int32, (C, block), 1)
    valid = offs < cl[:, None]
    idx = jnp.clip(cs[:, None] + offs, 0, max(P - 1, 0))
    doc = jnp.where(valid, post_doc[idx], jnp.int32(n_slots))
    contrib = jnp.where(valid, cw[:, None] * post_score[idx], jnp.float32(0.0))
    qrow = jnp.broadcast_to(cq[:, None], (C, block))
    qrow = jnp.where(valid, qrow, jnp.int32(Q))

    shift = max(int(n_slots).bit_length(), 1)
    if skip_sort:
        sq = qrow.reshape(-1)
        sd = doc.reshape(-1)
        sc = contrib.reshape(-1)
    elif (Q + 1) << shift <= 1 << 32:
        # Pack (q, doc) into one uint32 sort key — one fewer operand in the
        # flat sort, same stable (q, doc) order. doc occupies the low
        # `shift` bits (sentinel n_slots included), q the high bits.
        key = (
            qrow.reshape(-1).astype(jnp.uint32) << shift
        ) | doc.reshape(-1).astype(jnp.uint32)
        skey, sc = lax.sort((key, contrib.reshape(-1)), num_keys=1)
        sq = (skey >> shift).astype(jnp.int32)
        sd = (skey & jnp.uint32((1 << shift) - 1)).astype(jnp.int32)
    else:
        sq, sd, sc = lax.sort(
            (qrow.reshape(-1), doc.reshape(-1), contrib.reshape(-1)),
            num_keys=2,
        )
    first = jnp.concatenate(
        [
            jnp.ones((1,), bool),
            (sq[1:] != sq[:-1]) | (sd[1:] != sd[:-1]),
        ]
    )
    # skip_segsum (static, profiling only — totals are WRONG) replaces the
    # segmented scan with the raw contributions for stage attribution.
    # Group length is bounded by T (one lane per term slot per doc), so
    # the bounded serial fold applies at every envelope.
    stot = (
        sc if skip_segsum
        else _segmented_cumsum_bounded(sc, first, starts.shape[1])
    )
    last = jnp.concatenate(
        [
            (sq[1:] != sq[:-1]) | (sd[1:] != sd[:-1]),
            jnp.ones((1,), bool),
        ]
    )
    return sq, sd, stot, last


def per_query_counts(sq, indicator, Q):
    """Sum `indicator` per query over a q-sorted flat array (no scatter)."""
    cs = _cumsum_count_blocked(indicator)
    bounds = jnp.searchsorted(sq, jnp.arange(Q + 1, dtype=jnp.int32))
    csz = jnp.concatenate([jnp.zeros((1,), jnp.int32), cs])
    return csz[bounds[1:]] - csz[bounds[:-1]]


def _topk_quantized_reduce(key, pay, sq, Q, k2, sent_key, pad_payload):
    """Exact 2-level reduction of the quantized selection sort (sort2).

    The flat stream after light_totals is sorted by (q, doc): query q's
    lanes occupy one contiguous run [bounds[q], bounds[q+1]). Sorting the
    whole C*block stream to pick K2 per query is the sort2 stage; this
    shrinks the globally-sorted volume ~3x, exactly:

      1. sort each 128-lane row independently (row-parallel bitonic, ~28
         passes vs ~190+ for the global sort). The caller's keys KEEP the
         query id for every in-run lane (zero-score lanes included, which
         sink to their group's tail, not the row's), so each row's
         q-groups occupy exactly the lane counts of the (q, doc)-sorted
         layout — group g of query q starts at in-row lane bounds[q]-128r.
      2. keep each row's first k2 lanes. For every query this covers every
         row where it is the row's FIRST group: a global-top-k2 member
         ranks <= k2 inside any subset, so it sits in the group's — here
         the row's — first k2 lanes.
      3. the one row per query whose group starts mid-row (g > 0): its
         top-k2 sits at sorted-stream flat positions [bounds[q],
         bounds[q]+k2). One k2-wide gather per query collects them,
         masked to positions that are (a) not already in the row's first
         k2 (no duplicate lanes — a duplicate could displace a distinct
         doc from the pool and inflate the guard's tau), (b) inside the
         query's run, and (c) inside the row (the run's continuation in
         the next row is that row's FIRST group, covered by 2).
      4. the caller runs the ordinary flat sort on reduced + boundary
         lanes — identical per-query top-k2 content, tie order preserved
         (both sorts key on (key, pay)).
    """
    n = key.shape[0]
    nb = n // 128
    ks, ps = lax.sort(
        (key.reshape(nb, 128), pay.reshape(nb, 128)),
        dimension=1, num_keys=2,
    )
    red_k = ks[:, :k2].reshape(-1)
    red_p = ps[:, :k2].reshape(-1)
    bounds = jnp.searchsorted(
        sq, jnp.arange(Q + 1, dtype=jnp.int32)
    ).astype(jnp.int32)
    ksf = ks.reshape(-1)
    psf = ps.reshape(-1)
    start = bounds[:Q, None]  # [Q, 1]
    j = lax.broadcasted_iota(jnp.int32, (Q, k2), 1)
    pos = start + j
    g = start & 127
    row_end = (start | 127) + 1
    ok = (g + j >= k2) & (pos < row_end) & (pos < bounds[1:, None])
    pos = jnp.clip(pos, 0, n - 1)
    ex_k = jnp.where(ok, ksf[pos], sent_key).reshape(-1)
    ex_p = jnp.where(ok, psf[pos], pad_payload).reshape(-1)
    return (
        jnp.concatenate([red_k, ex_k]),
        jnp.concatenate([red_p, ex_p]),
    )


def per_query_topk_flat(sq, score, payload, Q, k2, pad_payload, *,
                        quantized: bool = False):
    """Top-k2 payload ids per query by (score desc, payload asc) from a
    flat list; returns (docs, vals) — vals are the selection scores (0 at
    invalid slots), consumed only by the fast-path guard threshold.

    quantized=False (the exact/wide path) keeps FULL f32 sort keys: a
    quantized packed key collapses near-uniform scores into false ties,
    where any K2-wide pool can exclude true top-K docs (same failure
    class as a bf16 H — found on a df=N term whose per-doc scores differ
    only in the 4th digit). There is no guard on that path, so the keys
    must be faithful.

    quantized=True (ONLY legal under the guarded fast path) packs
    (q, score) into ONE uint32 sort key — q in the high bits, the top
    (32 - qbits) bits of the positive-f32 score pattern (order-preserving
    truncation) inverted below — cutting the selection sort from 3
    operands to 2. Returned vals are the DEQUANTIZED FLOOR of each key
    (true score < floor * (1 + 2^-(22-qbits)) + ulp), and the caller
    widens its guard epsilon by that truncation bound, so any batch where
    a collapsed near-tie could reorder the top-K relaunches the exact
    wide kernel.
    """
    n = sq.shape[0]
    if quantized:
        qbits = (Q + 1).bit_length()
        shift = 32 - qbits
        max_sc = jnp.uint32((1 << shift) - 1)
        # positive normal f32 -> pattern >> qbits is a monotone, nonzero
        # (exp bits survive the shift for any qbits <= 22) selection key
        sc_hi = jnp.where(
            score > 0,
            lax.bitcast_convert_type(score, jnp.uint32) >> jnp.uint32(qbits),
            jnp.uint32(0),
        )
        # Zero-score lanes KEEP their query id (they sort to their group's
        # tail, past every positive lane, and the live filter below drops
        # them) — the 2-level reducer relies on every in-run lane staying
        # in its group so row layouts match the (q, doc)-sorted offsets.
        qv = jnp.where(sq < Q, sq.astype(jnp.uint32), jnp.uint32(Q))
        key = (qv << jnp.uint32(shift)) | (max_sc - sc_hi)
        pay = jnp.where(score > 0, payload, pad_payload)
        sent_key = (jnp.uint32(Q) << jnp.uint32(shift)) | max_sc
        # OFF by default: the stream arrives q-presorted (high key bits
        # already ordered), and the 2-level reduction only pays where the
        # flat sort cannot exploit that. Kept (with its exactness test)
        # until a GPU cell decides it.
        if (
            n >= 32768
            and n % 128 == 0
            and k2 <= 128
            and os.environ.get("NEXTSEARCH_SORT2_2LEVEL", "0") == "1"
        ):
            key, pay = _topk_quantized_reduce(
                key, pay, sq, Q, k2, sent_key, pad_payload
            )
        key2, pay2 = lax.sort((key, pay), num_keys=2)
        m = key2.shape[0]
        q2 = (key2 >> jnp.uint32(shift)).astype(jnp.int32)
        sc2 = max_sc - (key2 & max_sc)
        pos = jnp.searchsorted(q2, jnp.arange(Q, dtype=jnp.int32))
        idx = pos[:, None] + lax.broadcasted_iota(jnp.int32, (Q, k2), 1)
        in_q = (
            idx
            < jnp.searchsorted(q2, jnp.arange(1, Q + 1, dtype=jnp.int32))[
                :, None
            ]
        )
        idx = jnp.clip(idx, 0, m - 1)
        sc_at = sc2[idx]
        live = in_q & (sc_at > 0)
        docs = jnp.where(live, pay2[idx], pad_payload)
        vals = jnp.where(
            live,
            lax.bitcast_convert_type(
                sc_at << jnp.uint32(qbits), jnp.float32
            ),
            jnp.float32(0.0),
        )
        return docs, vals
    neg = jnp.where(score > 0, -score, jnp.float32(jnp.inf))
    pay = jnp.where(score > 0, payload, pad_payload)
    q2, neg2, pay2 = lax.sort((sq, neg, pay), num_keys=3)
    invalid = ~(neg2 < jnp.inf)
    pos = jnp.searchsorted(q2, jnp.arange(Q, dtype=jnp.int32))
    idx = pos[:, None] + lax.broadcasted_iota(jnp.int32, (Q, k2), 1)
    in_q = idx < jnp.searchsorted(q2, jnp.arange(1, Q + 1, dtype=jnp.int32))[:, None]
    idx = jnp.clip(idx, 0, n - 1)
    live = in_q & ~invalid[idx]
    docs = jnp.where(live, pay2[idx], pad_payload)
    vals = jnp.where(live, -neg2[idx], jnp.float32(0.0))
    return docs, vals


def _bf16_pair_words(H, Q, n):
    """uint32 word view of a bf16 array's element pairs: every random
    access into a bf16 H goes through a 32-bit gather of the containing
    pair, avoiding sub-word (16-bit) gathers."""
    return lax.bitcast_convert_type(
        H.reshape(Q, n // 2, 2), jnp.uint32
    )  # [Q, n/2]; element 0 = low 16 bits (little-endian)


def _bf16_hi_f32(word16):
    """uint32 whose low 16 bits are a bf16 pattern -> that value as f32."""
    return lax.bitcast_convert_type(
        (word16 & jnp.uint32(0xFFFF)) << jnp.uint32(16), jnp.float32
    )


def heavy_candidates(H, smax_sq, k2, Q, n_slots):
    """Top-k2 doc slots per query from per-sub-tile maxima (exact: a top
    doc's own sub-tile max is >= its score, so its sub-tile is among the
    top-k2 sub-tiles). CSUB granularity keeps the H gather at k2*CSUB per
    query instead of k2*TILE.

    H may be 2D [Q, n_slots] (the unified-totals path) or the packed
    pipeline's 3D [Q, n_slots/128, 128] — CSUB == 128 makes the 3D blocks
    exactly the sub-tiles."""
    n_sub = n_slots // CSUB
    smax = jnp.transpose(smax_sq)[:, :n_sub]  # [Q, n_sub]
    kt = min(k2, n_sub)
    _tv, tidx = lax.top_k(smax, kt)
    tidx = jnp.sort(tidx, axis=1)  # keep canonical doc-asc tie order
    if H.dtype == jnp.bfloat16:
        # gather whole sub-tiles as uint32 pairs, then unpack both halves
        # (doc order: word w half h -> doc w*2 + h)
        csw = CSUB // 2
        if H.ndim == 3:
            tiles = lax.bitcast_convert_type(
                H.reshape(Q, n_sub, csw, 2), jnp.uint32
            )
        else:
            tiles = _bf16_pair_words(H, Q, n_slots).reshape(Q, n_sub, csw)
        cand = jnp.take_along_axis(tiles, tidx[:, :, None], axis=1)
        lo = _bf16_hi_f32(cand)
        hi = _bf16_hi_f32(cand >> jnp.uint32(16))
        flat = jnp.stack([lo, hi], axis=-1).reshape(Q, kt * CSUB)
    else:
        tiles = H if H.ndim == 3 else H.reshape(Q, n_sub, CSUB)
        cand_tiles = jnp.take_along_axis(tiles, tidx[:, :, None], axis=1)
        flat = cand_tiles.reshape(Q, kt * CSUB).astype(jnp.float32)
    vals, pos = lax.top_k(flat, min(k2, kt * CSUB))
    which = pos // CSUB
    base = jnp.take_along_axis(tidx, which, axis=1) * CSUB
    docs = jnp.where(vals > 0, base + pos % CSUB, jnp.int32(2**30))
    return vals, docs.astype(jnp.int32)


BUCKET_LOG2 = 3  # heavy bucket-position granularity (8 doc slots)
# Light bucket-position granularity (512 doc slots). Finer buckets cost
# 4x table memory vs 2048-slot buckets (~1.6GB at 1M docs x 200k vocab,
# device-built) but cut the max bucket occupancy — and the rescore's
# binary-search depth is exactly that occupancy's bit length, each step
# one [Q, T, kc] random gather.
LIGHT_BUCKET_LOG2 = 9


def _round_up_16(n: int) -> int:
    return ((n + 15) // 16) * 16


def exact_rescore_v2(
    post_doc,
    post_score,
    bucket_pos,
    light_bucket_pos,
    starts,
    slot_dense,
    slot_light,
    weights,
    cand,
    *,
    bs_steps,
    nd,
    nl,
    lb_log2: int = LIGHT_BUCKET_LOG2,
):
    """Bit-exact term-slot-order rescore of candidates.

    One unified vectorized lower_bound over each (query, term slot)'s
    doc-sorted posting range — light AND heavy slots alike — with
    contribution = w * post_score[pos], the HOST-precomputed eager score
    (index/builder.eager_scores, platform logf idf). Reusing host f32
    values means the device only performs adds/multiplies in a fixed
    order, which is what makes the parity guarantee portable: an earlier
    variant reconstructed heavy scores on device from a dense tf table
    and matched on CPU but broke on an accelerator whose f32 division
    does not round like the host's, costing ~1 ULP on heavy terms.

    Both slot kinds narrow their search range through a host-precomputed
    bucket-position table (first-posting offset per doc-slot bucket):
    heavy slots via `bucket_pos` [ND+1, NBh+1] at 2^BUCKET_LOG2-slot
    granularity (fine: dense rows can be nearly full), light slots via
    `light_bucket_pos` [NL+1, NBl+1] at 2^LIGHT_BUCKET_LOG2 (coarse: a
    light df is capped by the dense threshold, so buckets stay shallow).
    The tables only narrow the provable range — positions and scores are
    exact regardless. bs_steps must cover the maximum bucket OCCUPANCY of
    either table (measured host-side at build: DeviceIndex._bs_depth),
    which at 1M docs drops the depth from 11 (df-bounded) to ~6.
    """
    Q, T = starts.shape
    kc = cand.shape[1]
    P = post_doc.shape[0]
    c = cand[:, None, :]  # [Q, 1, kc]

    s = starts[:, :, None].astype(jnp.int32)
    is_heavy = slot_dense[:, :, None] < nd  # [Q, T, 1]
    row = jnp.where(is_heavy, slot_dense[:, :, None], nd)
    lrow = jnp.clip(slot_light[:, :, None], 0, nl)
    cb = lax.shift_right_logical(c, BUCKET_LOG2)  # [Q, 1, kc]
    cbl = lax.shift_right_logical(c, lb_log2)
    lo0 = jnp.where(
        is_heavy, bucket_pos[row, cb], light_bucket_pos[lrow, cbl]
    )
    hi0 = jnp.where(
        is_heavy, bucket_pos[row, cb + 1], light_bucket_pos[lrow, cbl + 1]
    )
    lo = jnp.broadcast_to(lo0, (Q, T, kc))
    hi = jnp.broadcast_to(hi0, (Q, T, kc))

    def bs_step(_i, state):
        lo, hi = state
        mid = (lo + hi) // 2
        v = post_doc[jnp.clip(s + mid, 0, max(P - 1, 0))]
        go_right = v < c
        return (jnp.where(go_right, mid + 1, lo), jnp.where(go_right, hi, mid))

    lo, hi = lax.fori_loop(0, bs_steps, bs_step, (lo, hi))
    pos = jnp.clip(s + lo, 0, max(P - 1, 0))
    w = weights[:, :, None]
    hit = (lo < hi0) & (post_doc[pos] == c) & (w != 0.0)
    # jnp.abs blocks XLA from contracting `acc + w*score` into an fma,
    # which would skip the intermediate rounding the C++ engine performs
    # (all contributions are non-negative, so abs is bit-exact).
    term_contrib = jnp.where(
        hit, jnp.abs(w * post_score[pos]), jnp.float32(0.0)
    )

    def acc_step(t, acc):
        return acc + lax.dynamic_index_in_dim(
            term_contrib, t, axis=1, keepdims=False
        )

    return lax.fori_loop(0, T, acc_step, jnp.zeros((Q, kc), jnp.float32))


def exact_rescore_v4(
    post_doc,
    post_score,
    dense_rows3,
    light_bucket_pos,
    starts,
    slot_dense,
    slot_light,
    weights,
    cand,
    *,
    bs_steps,
    nd,
    nl,
    L2,
    lb_log2: int = LIGHT_BUCKET_LOG2,
):
    """v3 with the light binary search COMPACTED to the live light pairs.

    v3 runs its bucket-narrowed lower_bound over every [Q, T, kc] lane —
    but on a Zipf query mix most (query, slot) pairs are heavy or padding
    (~70-80%% of live slots are dense-row terms at the 1M synthetic corpus,
    plus T-envelope padding), and each search step is a [Q*T*kc] random
    gather. Here the light pairs are packed to
    a static [L2, kc] block (device-side exclusive prefix over the light
    mask + a tiny Q*T scatter — the row-major pair order is the host
    plan's), searched there, and gathered back into the [Q, T, kc]
    accumulation grid. The per-query accumulation loop is UNCHANGED — the
    same values add in the same term-slot order, so scores stay
    bit-identical to v3/v2/the C++ engine. L2 is a static bucket
    (DeviceIndex pins it like C); overflow pairs escape via the caller
    choosing a bigger bucket, never silently.
    """
    Q, T = starts.shape
    kc = cand.shape[1]
    P = post_doc.shape[0]
    c = cand[:, None, :]  # [Q, 1, kc]

    is_heavy = slot_dense[:, :, None] < nd  # [Q, T, 1]
    row = jnp.where(is_heavy, slot_dense[:, :, None], nd)  # nd = zero row
    rowb = jnp.broadcast_to(row, (Q, T, kc))
    cb = jnp.broadcast_to(c, (Q, T, kc))
    dv = dense_rows3[
        rowb, lax.shift_right_logical(cb, 7), cb & jnp.int32(127)
    ]  # f32 [Q, T, kc]: exact eager score, 0 where the doc lacks the term

    # ---- compact the light pairs: row-major (q, t) order
    is_light = (slot_light < nl) & (weights != 0.0)  # [Q, T]
    lflat = is_light.reshape(-1)
    lidx = jnp.cumsum(lflat.astype(jnp.int32)) - 1
    lidx = jnp.where(lflat, jnp.minimum(lidx, L2), L2)  # oob -> dropped
    lp_start = jnp.zeros((L2 + 1,), jnp.int32).at[lidx].set(
        starts.reshape(-1).astype(jnp.int32), mode="drop"
    )
    lp_row = jnp.full((L2 + 1,), nl, jnp.int32).at[lidx].set(
        slot_light.reshape(-1), mode="drop"
    )
    qgrid = jnp.broadcast_to(
        lax.broadcasted_iota(jnp.int32, (Q, T), 0).reshape(-1),
        (Q * T,),
    )
    lp_q = jnp.zeros((L2 + 1,), jnp.int32).at[lidx].set(qgrid, mode="drop")

    cl = cand[jnp.clip(lp_q, 0, Q - 1)]  # [L2+1, kc]
    s = lp_start[:, None]
    cbl = lax.shift_right_logical(cl, lb_log2)
    lrow = jnp.clip(lp_row[:, None], 0, nl)
    lo = light_bucket_pos[lrow, cbl]
    hi0 = light_bucket_pos[lrow, cbl + 1]
    hi = hi0

    def bs_step(_i, state):
        lo, hi = state
        mid = (lo + hi) // 2
        v = post_doc[jnp.clip(s + mid, 0, max(P - 1, 0))]
        go_right = v < cl
        return (jnp.where(go_right, mid + 1, lo), jnp.where(go_right, hi, mid))

    lo, hi = lax.fori_loop(0, bs_steps, bs_step, (lo, hi))
    pos = jnp.clip(s + lo, 0, max(P - 1, 0))
    lhit = (lo < hi0) & (post_doc[pos] == cl)
    v_light = jnp.where(lhit, post_score[pos], jnp.float32(0.0))
    v_light = v_light.at[L2].set(0.0)  # sentinel row: heavy/padding pairs

    # ---- reassemble the [Q, T, kc] value grid; accumulation unchanged
    vl = v_light[lidx].reshape(Q, T, kc)
    w = weights[:, :, None]
    v = jnp.where(is_heavy, dv, vl)
    hit = (v > 0.0) & (w != 0.0)
    # jnp.abs blocks XLA from contracting `acc + w*score` into an fma,
    # which would skip the intermediate rounding the C++ engine performs
    # (all contributions are non-negative, so abs is bit-exact).
    term_contrib = jnp.where(hit, jnp.abs(w * v), jnp.float32(0.0))

    def acc_step(t, acc):
        return acc + lax.dynamic_index_in_dim(
            term_contrib, t, axis=1, keepdims=False
        )

    return lax.fori_loop(0, T, acc_step, jnp.zeros((Q, kc), jnp.float32))


def exact_rescore_v5(
    post_doc,
    post_score,
    dense_rows3,
    light_bucket_pos,
    starts,
    slot_dense,
    slot_light,
    weights,
    cand,
    *,
    bs_steps,
    nd,
    nl,
    L2,
    H2,
    lb_log2: int = LIGHT_BUCKET_LOG2,
):
    """v4 with the HEAVY value gather compacted to the live heavy pairs.

    v4 compacted the light binary search to [L2, kc] lanes but still
    gathered heavy values over the FULL [Q, T, kc] grid — at the 1M
    serving point that is Q*T*kc (512*16*32 = 262k) random element
    gathers into the multi-GB dense table, of which only ~8-12% are live
    heavy (query, slot) pairs (~1.2 dense terms per Zipf query against a
    T=16 envelope); every dead lane still pays a random cache-line touch. Here the live heavy pairs are packed to a static
    [H2, kc] block by the same device-side prefix-scatter v4 uses for the
    light pairs, ONLY those rows gather from the dense table, and the
    [Q, T, kc] grid is reassembled by a row gather from the small block
    (contiguous kc-wide f32 rows of a ~H2*kc*4B table — streams, not
    random cache lines). The accumulation grid and order are UNCHANGED,
    so scores stay bit-identical to v4/v3/v2/the C++ engine
    (/root/reference/src/api_engine.cpp:473-481 term-order f32 adds).

    H2 (static) must cover the batch's live heavy pair count — DeviceIndex
    sizes and pins it like L2; overflow escapes via a bigger bucket at the
    caller, never silently.
    """
    Q, T = starts.shape
    kc = cand.shape[1]
    P = post_doc.shape[0]
    c = cand[:, None, :]  # [Q, 1, kc]

    is_heavy = slot_dense[:, :, None] < nd  # [Q, T, 1]

    # ---- compact the heavy pairs: row-major (q, t) order
    hflat = ((slot_dense < nd) & (weights != 0.0)).reshape(-1)
    hidx = jnp.cumsum(hflat.astype(jnp.int32)) - 1
    hidx = jnp.where(hflat, jnp.minimum(hidx, H2), H2)  # oob -> dropped
    hp_row = jnp.full((H2 + 1,), nd, jnp.int32).at[hidx].set(
        jnp.where(hflat, slot_dense.reshape(-1), nd), mode="drop"
    )
    qgrid_h = lax.broadcasted_iota(jnp.int32, (Q, T), 0).reshape(-1)
    hp_q = jnp.zeros((H2 + 1,), jnp.int32).at[hidx].set(
        qgrid_h, mode="drop"
    )
    chv = cand[jnp.clip(hp_q, 0, Q - 1)]  # [H2+1, kc]
    dvc = dense_rows3[
        jnp.clip(hp_row, 0, nd)[:, None],
        lax.shift_right_logical(chv, 7),
        chv & jnp.int32(127),
    ]  # f32 [H2+1, kc]: exact eager score, 0 where the doc lacks the term
    dvc = dvc.at[H2].set(0.0)  # sentinel row: light/padding/oob pairs
    dv = dvc[hidx].reshape(Q, T, kc)

    # ---- compact the light pairs: row-major (q, t) order (v4 verbatim)
    is_light = (slot_light < nl) & (weights != 0.0)  # [Q, T]
    lflat = is_light.reshape(-1)
    lidx = jnp.cumsum(lflat.astype(jnp.int32)) - 1
    lidx = jnp.where(lflat, jnp.minimum(lidx, L2), L2)  # oob -> dropped
    lp_start = jnp.zeros((L2 + 1,), jnp.int32).at[lidx].set(
        starts.reshape(-1).astype(jnp.int32), mode="drop"
    )
    lp_row = jnp.full((L2 + 1,), nl, jnp.int32).at[lidx].set(
        slot_light.reshape(-1), mode="drop"
    )
    lp_q = jnp.zeros((L2 + 1,), jnp.int32).at[lidx].set(
        qgrid_h, mode="drop"
    )

    cl = cand[jnp.clip(lp_q, 0, Q - 1)]  # [L2+1, kc]
    s = lp_start[:, None]
    cbl = lax.shift_right_logical(cl, lb_log2)
    lrow = jnp.clip(lp_row[:, None], 0, nl)
    lo = light_bucket_pos[lrow, cbl]
    hi0 = light_bucket_pos[lrow, cbl + 1]
    hi = hi0

    def bs_step(_i, state):
        lo, hi = state
        mid = (lo + hi) // 2
        v = post_doc[jnp.clip(s + mid, 0, max(P - 1, 0))]
        go_right = v < cl
        return (jnp.where(go_right, mid + 1, lo), jnp.where(go_right, hi, mid))

    lo, hi = lax.fori_loop(0, bs_steps, bs_step, (lo, hi))
    pos = jnp.clip(s + lo, 0, max(P - 1, 0))
    lhit = (lo < hi0) & (post_doc[pos] == cl)
    v_light = jnp.where(lhit, post_score[pos], jnp.float32(0.0))
    v_light = v_light.at[L2].set(0.0)  # sentinel row: heavy/padding pairs

    # ---- reassemble the [Q, T, kc] value grid; accumulation unchanged
    vl = v_light[lidx].reshape(Q, T, kc)
    w = weights[:, :, None]
    v = jnp.where(is_heavy, dv, vl)
    hit = (v > 0.0) & (w != 0.0)
    # jnp.abs blocks XLA from contracting `acc + w*score` into an fma,
    # which would skip the intermediate rounding the C++ engine performs
    # (all contributions are non-negative, so abs is bit-exact).
    term_contrib = jnp.where(hit, jnp.abs(w * v), jnp.float32(0.0))

    def acc_step(t, acc):
        return acc + lax.dynamic_index_in_dim(
            term_contrib, t, axis=1, keepdims=False
        )

    return lax.fori_loop(0, T, acc_step, jnp.zeros((Q, kc), jnp.float32))


def _dedup_sorted(vals, docs):
    """Kill duplicate docs in a (score desc, doc asc)-sorted candidate list."""
    dup = jnp.concatenate(
        [jnp.zeros((vals.shape[0], 1), bool), docs[:, 1:] == docs[:, :-1]],
        axis=1,
    ) & (docs < 2**30)
    vals = jnp.where(dup, jnp.float32(0.0), vals)
    docs = jnp.where(dup, jnp.int32(2**30), docs)
    return canonical_sort(vals, docs)


@functools.partial(
    jax.jit,
    static_argnames=(
        "n_slots", "K", "K2", "C", "block", "bs_steps", "nd", "nl", "U",
        "heavy_direct", "fast_heavy", "guard_eps", "L2",
    ),
)
def bm25_search_sparse_unified(
    post_doc: jax.Array,  # int32 [P]
    post_score: jax.Array,  # f32 [P]
    dense_rows: jax.Array,  # f32 3D [rows, n_slots/128, 128]
    bucket_pos: jax.Array,  # int32 [ND+1, NBh+1] heavy bucket positions
    light_bucket_pos: jax.Array,  # int32 [NL+1, NBl+1] light bucket positions
    plan: jax.Array,  # int32 [7, Q, T] — see bm25_search_sparse_packed
    *,
    n_slots: int,
    K: int,
    K2: int,
    C: int,
    block: int,
    bs_steps: int,
    nd: int,
    nl: int,
    U: int,
    heavy_direct: bool = True,
    fast_heavy: bool = False,
    guard_eps: float = 2e-3,
    L2: int = 0,
):
    """Unified-totals sparse search: light contributions are added INTO
    the heavy matmul output, so selection and the matched-doc count read
    off ONE exact [Q, n_slots] totals matrix. Off by default
    (config.DeviceConfig.unified).

    Replaces the split light path (global (q, doc) sort + segmented sum +
    selection sort + H-gather + distinct-count scans) with:

      expand   light posting windows -> (doc, query, contribution)
               entries; contributions are the host-precomputed eager f32
               scores, strictly positive, so totals > 0 exactly on the
               docs the reference's accumulation loop touches
               (src/api_engine.cpp:473-496)
      sort     ONE device sort of the entries by doc slot, packed into
               aligned windows
      fuse     unified_fused_xla: heavy matmul + scatter-add of the
               entries + per-sub-tile maxima + exact positive counts
               (ops/heavy.py)
      found    sum of tile counts — exact (#docs with >= 1 matched term)
      select   ONE K2-wide pool from per-sub-tile maxima of EXACT totals
               (a doc's own sub-tile max >= its total), half the rescore
               width of the two-pool packed kernel
      rescore  bit-exact f32 re-accumulation, unchanged (exact_rescore_v2)

    Output packed f32 [Q, 2K+1] like bm25_search_sparse_packed.

    fast_heavy=True is the GUARDED fast mode (the unified analog of
    _packed_impl's): the heavy dot runs in TF32 (ops/heavy.heavy_matmul)
    while the light-entry application stays f32. Selection reads the single K2-wide pool off the
    approximate totals; the guard column proves per query that every
    excluded doc's TRUE score <= (1+eps) * tau where tau is the K2-th
    pool value (subtile-stage exclusions are covered because each
    selected subtile's max is itself in the flat pool) and eps bounds the
    heavy part's TF32 relative error (the light part's only error is
    f32 summation-order rounding, ~2^-20 relative, absorbed by the same
    margin). On guard failure the CALLER relaunches the exact wide packed
    kernel — identical trip protocol to the split fast path. `found` and
    the rescored scores are exact at either precision. Output gains the
    guard column: [Q, 2K+2]. L2 > 0 routes the rescore through
    exact_rescore_v4 (light binary search compacted to [L2, kc] lanes).
    """
    from .heavy import ENT_G, ENT_W, TILE, unified_fused_xla

    starts = plan[0]
    light_dfs = plan[1]
    slot_dense = plan[2]
    slot_light = plan[3]
    slot_compact = plan[4]
    weights = lax.bitcast_convert_type(plan[5], jnp.float32)
    Q, T = starts.shape

    # ---- compact heavy mix (identical to the packed kernel's compact
    # path).
    m = min(U, Q * T)
    ids_flat = plan[6].reshape(-1)[:m]
    uc = _round_up_16(U + 1)
    ids = jnp.concatenate([ids_flat, jnp.full((uc - m,), nd, jnp.int32)])
    ids = jnp.clip(ids, 0, dense_rows.shape[0] - 1)
    iota_u = lax.broadcasted_iota(jnp.int32, (1, uc), 1)

    def mix_step(t, mm):
        sc_t = lax.dynamic_index_in_dim(slot_compact, t, axis=1, keepdims=True)
        w_t = lax.dynamic_index_in_dim(weights, t, axis=1, keepdims=True)
        return mm + jnp.where(sc_t == iota_u, w_t, jnp.float32(0.0))

    mix = lax.fori_loop(0, T, mix_step, jnp.zeros((Q, uc), jnp.float32))
    mix = mix.at[:, U].set(0.0)  # light/padding slots -> zero row

    table = dense_rows[ids].reshape(ids.shape[0], n_slots)

    # ---- light entries: expand, sort by doc slot, pack aligned windows.
    cs, cl, cq, cw = expand_chunks(starts, light_dfs, weights, C=C, block=block)
    P = post_doc.shape[0]
    offs = lax.broadcasted_iota(jnp.int32, (C, block), 1)
    valid = offs < cl[:, None]
    idx = jnp.clip(cs[:, None] + offs, 0, max(P - 1, 0))
    # invalid entries carry doc = n_slots: they sort past every sub-tile
    # bound and past the live entry count
    doc = jnp.where(valid, post_doc[idx], jnp.int32(n_slots))
    contrib = jnp.where(valid, cw[:, None] * post_score[idx], jnp.float32(0.0))
    qrow = jnp.clip(jnp.broadcast_to(cq[:, None], (C, block)), 0, Q - 1)
    qshift = max((Q - 1).bit_length(), 1)
    if (n_slots + 1) << qshift <= 1 << 32:
        # Pack (doc, q) into one uint32 sort key — one fewer operand in
        # the flat sort; entry application is order-free so the
        # (doc, q) refinement of the doc order is equivalent.
        key = (
            doc.reshape(-1).astype(jnp.uint32) << qshift
        ) | qrow.reshape(-1).astype(jnp.uint32)
        skey, sv = lax.sort((key, contrib.reshape(-1)), num_keys=1)
        sd = (skey >> qshift).astype(jnp.int32)
        sq = (skey & jnp.uint32((1 << qshift) - 1)).astype(jnp.int32)
    else:
        sd, sq, sv = lax.sort(
            (doc.reshape(-1), qrow.reshape(-1), contrib.reshape(-1)),
            num_keys=1,
        )
    # entry offsets per TILE-doc tile
    n_tiles = n_slots // TILE
    bounds = jnp.arange(0, n_tiles + 1, dtype=jnp.int32) * TILE
    eoff = jnp.searchsorted(sd, bounds, side="left").astype(jnp.int32)
    # pack aligned ENT_W-entry windows [NW, 8, ENT_W] int32 (rows: doc /
    # query / value-bits / 5 spare) plus 2*ENT_G trailing sentinel
    # windows.
    N = C * block
    Np = ((N + ENT_W - 1) // ENT_W) * ENT_W + 2 * ENT_G * ENT_W
    pad = Np - N
    sd = jnp.concatenate([sd, jnp.full((pad,), n_slots, jnp.int32)])
    sq = jnp.concatenate([sq, jnp.zeros((pad,), jnp.int32)])
    sv = jnp.concatenate([sv, jnp.zeros((pad,), jnp.float32)])
    nw = Np // ENT_W
    ent_pack = jnp.concatenate(
        [
            sd.reshape(nw, 1, ENT_W),
            sq.reshape(nw, 1, ENT_W),
            lax.bitcast_convert_type(sv, jnp.int32).reshape(nw, 1, ENT_W),
            jnp.zeros((nw, 5, ENT_W), jnp.int32),
        ],
        axis=1,
    )

    totals, smax_sq, cnt_tq = unified_fused_xla(
        mix.astype(table.dtype), table, ent_pack, eoff, fast=fast_heavy,
    )
    found = jnp.sum(cnt_tq, axis=0).astype(jnp.int32)

    # ---- single K2 candidate pool by totals (one pool: totals already
    # include light + heavy, so the packed kernel's light/heavy pool
    # union — and its duplicate kill — is unnecessary). Under fast_heavy
    # the pool values are approximate and the guard below covers them.
    pool_vals, cand = heavy_candidates(totals, smax_sq, K2, Q, n_slots)
    cand = jnp.where(cand >= n_slots, jnp.int32(2**30), cand)

    safe_cand = jnp.clip(cand, 0, n_slots - 1)
    if heavy_direct:
        # v3 (uncompacted heavy-direct rescore) retired in r4: every live
        # caller sizes/pins L2 (DeviceIndex._light_budget), so the compact
        # v4 path is the only heavy-direct generation kept.
        if L2 <= 0:
            raise ValueError("heavy_direct rescore requires L2 > 0")
        exact = exact_rescore_v4(
            post_doc, post_score, dense_rows, light_bucket_pos, starts,
            slot_dense, slot_light, weights, safe_cand,
            bs_steps=bs_steps, nd=nd, nl=nl, L2=L2,
        )
    else:
        exact = exact_rescore_v2(
            post_doc, post_score, bucket_pos, light_bucket_pos, starts,
            slot_dense, slot_light, weights, safe_cand,
            bs_steps=bs_steps, nd=nd, nl=nl,
        )
    exact = jnp.where(cand < n_slots, exact, jnp.float32(0.0))
    sval, sdoc = canonical_sort(exact, safe_cand)

    cols = [
        sval[:, :K],
        sdoc[:, :K].astype(jnp.float32),
        found[:, None].astype(jnp.float32),
    ]
    if fast_heavy:
        # Guard: every doc excluded from the single K2 pool has
        # approximate total <= tau (the K2-th pool value; subtile-stage
        # exclusions are bounded by their subtile max, which is itself in
        # the pool), hence TRUE total <= (1+eps) * tau. Strict > keeps
        # boundary ties (reference breaks ties doc-ascending) on the
        # relaunch path.
        tau = pool_vals[:, K2 - 1]
        kth = sval[:, K - 1]
        ok = (kth > (1.0 + guard_eps) * tau) | (tau <= 0.0)
        cols.append(ok.astype(jnp.float32)[:, None])
    return jnp.concatenate(cols, axis=1)


def _packed_impl(
    post_doc: jax.Array,  # int32 [P]
    post_score: jax.Array,  # f32 [P]
    dense_rows: jax.Array,  # bf16/f32 3D [rows, n_slots/128, 128]
    bucket_pos: jax.Array,  # int32 [ND+1, NBh+1] heavy bucket positions
    light_bucket_pos: jax.Array,  # int32 [NL+1, NBl+1] light bucket positions
    plan: jax.Array,  # int32 [7, Q, T] — ONE upload per batch:
    #   starts / light_dfs / slot_dense / slot_light / slot_compact /
    #   weight f32 bit patterns / unique dense row ids (row-major, first U
    #   of Q*T entries; U <= Q*T because every unique id comes from a
    #   (query, slot)). Weights travel as a pure bitcast: BM25 weights are
    #   normal floats, never denormal, so the denormal-flush hazard that
    #   rules out value-packing int ids into f32 lanes does not apply.
    *,
    n_slots: int,
    K: int,
    K2: int,
    C: int,
    block: int,
    bs_steps: int,
    nd: int,
    nl: int,
    U: int,
    use_compact: bool = False,
    heavy_direct: bool = True,
    fast_heavy: bool = False,
    guard_eps: float = 2e-3,
    h_bf16: bool = False,
    lb_log2: int = LIGHT_BUCKET_LOG2,
    L2: int = 0,
    H2: int = 0,
    prof_skip: tuple = (),
):
    """Transfer-minimal sparse search; output packed f32 [Q, 2K+1] like
    bm25_search_packed (vals | doc slots | found as exact f32 values).

    L2 > 0 (static; must cover the batch's live light (query, slot) pair
    count — DeviceIndex sizes and pins it like C) routes the rescore
    through exact_rescore_v4, which compacts the light binary search to
    [L2, kc] lanes instead of [Q*T, kc]; 0 keeps v3. H2 > 0 (static; live
    heavy pair count, pinned like L2) additionally compacts the heavy
    value gather to [H2, kc] (exact_rescore_v5).

    prof_skip (static, profiling only — results are WRONG when non-empty)
    disables named stages so a profiling harness can attribute
    per-stage cost by timing the REAL kernel minus one stage at a time:
    "rowgather" (compact row gather -> zero table), "heavy_mm" (whole heavy
    block), "light" (light totals chain), "hgather" (H values at light
    docs), "sort2" (light selection sort), "cand_heavy" (heavy candidate
    extraction), "rescore" (exact rescore).

    fast_heavy=True is the GUARDED fast path: the heavy matmul runs in
    TF32 over TF32-rounded operands (ops/heavy.heavy_matmul) and the
    light/heavy pools merge into ONE K2-wide candidate set (half the
    rescore width). Both approximations are covered by a per-query proof
    emitted as an extra output column: every doc excluded from the pool
    has approximate selection score <= tau (the K2-th approx value at each
    of the three selection stages), hence TRUE score <= (1+eps)*tau, where
    eps bounds the TF32 product's relative error (config.DeviceConfig.
    fast_heavy_eps; the stot part of light selection scores is exact,
    which only tightens the bound). If the exact K-th rescored score >
    (1+eps)*tau, no excluded doc can reach the top K and the result
    equals the exact path's
    bit-for-bit; otherwise the guard column reads 0 and the CALLER MUST
    relaunch with fast_heavy=False (index/segment.py does). Positivity —
    and therefore `found` and the light/heavy doc classification — is
    exact at any precision: every operand is positive, so no cancellation.
    Output gains the guard column: [Q, 2K+2].
    """
    starts = plan[0]
    light_dfs = plan[1]
    slot_dense = plan[2]
    slot_light = plan[3]
    slot_compact = plan[4]
    weights = lax.bitcast_convert_type(plan[5], jnp.float32)
    Q, T = starts.shape

    # Heavy matmul operand. Two strategies:
    #   full table: mix [Q, ND] over the whole dense table; work
    #     Q*ND*n_slots and a whole-table read, no gather.
    #   compact (use_compact=True): gather the <=U distinct rows the batch
    #     references into [uc, n_slots] and mix over COMPACT ids — a few
    #     times fewer FLOPs for one whole-row gather of the U rows.
    if use_compact:
        # U is the BUCKETED table size and can exceed the Q*T id-row
        # capacity on small batches; entries past the true unique count
        # are sentinel padding either way.
        m = min(U, Q * T)
        ids_flat = plan[6].reshape(-1)[:m]
        uc = _round_up_16(U + 1)
        ids = jnp.concatenate(
            [ids_flat, jnp.full((uc - m,), nd, jnp.int32)]
        )  # trailing entries = zero sentinel row
        ids = jnp.clip(ids, 0, dense_rows.shape[0] - 1)
        iota_u = lax.broadcasted_iota(jnp.int32, (1, uc), 1)
        sid = slot_compact
        zero_col = U
        mix_cols = uc
    else:
        iota_u = lax.broadcasted_iota(
            jnp.int32, (1, dense_rows.shape[0]), 1
        )
        sid = slot_dense
        zero_col = nd
        mix_cols = dense_rows.shape[0]

    def mix_step(t, m):
        sc_t = lax.dynamic_index_in_dim(sid, t, axis=1, keepdims=True)
        w_t = lax.dynamic_index_in_dim(weights, t, axis=1, keepdims=True)
        return m + jnp.where(sc_t == iota_u, w_t, jnp.float32(0.0))

    mix = lax.fori_loop(
        0, T, mix_step, jnp.zeros((Q, mix_cols), jnp.float32)
    )
    mix = mix.at[:, zero_col].set(0.0)  # light/padding slots

    # Guarded bf16 H storage (h_bf16, OFF by default): the [Q, n_slots]
    # H tile is the heavy step's dominant write (2GB at Q=512) and
    # storing it bf16 halves that plus the downstream H-gather traffic,
    # BUT the guard's tau then inflates by the storage rounding no matter
    # which way it rounds (round-toward-+inf, _round_up_store, moves 2^-9
    # into the K2-th pool value itself). Near-uniform heavy tails (Zipf
    # at 1M docs: the 10th..32nd candidates sit within ~0.1% of each
    # other) then trip persistently. Kept behind a static for workloads
    # with separated heavy tails. Positivity (found counts, light/heavy
    # classification) is exact at any storage precision.
    h_dtype = jnp.bfloat16 if (fast_heavy and h_bf16) else jnp.float32
    # dense_rows is STORED [rows, n_slots/128, 128] and H comes back in
    # the same 3D layout; consumers index (d >> 7, d & 127).
    if "heavy_mm" in prof_skip:
        from .heavy import _CPT, TILE

        tiles_pad = ((n_slots // TILE + 7) // 8) * 8
        H = jnp.zeros((Q, n_slots // 128, 128), h_dtype)
        smax_sq = jnp.zeros((tiles_pad * _CPT, Q), jnp.float32)
        heavy_found = jnp.zeros((Q,), jnp.int32)
    else:
        if use_compact:
            # whole-row gather of exactly the referenced rows
            if "rowgather" in prof_skip:
                table3 = jnp.zeros(
                    (ids.shape[0],) + dense_rows.shape[1:], dense_rows.dtype
                )
            else:
                table3 = dense_rows[ids]
            H, smax_sq, cnt_tq = heavy_fused3_xla(
                mix, table3, fast=fast_heavy, h_dtype=h_dtype
            )
        else:
            # full-table: read the stored table directly (no compact
            # gather buffer) so this step — the exact relaunch — compiles
            # at ANY envelope.
            H, smax_sq, cnt_tq = heavy_fused3_xla(
                mix, dense_rows, fast=fast_heavy, h_dtype=h_dtype
            )
        heavy_found = jnp.sum(cnt_tq, axis=0).astype(jnp.int32)  # [Q]

    # ---- light flat totals
    if "light" in prof_skip:
        found = heavy_found
        ldocs = jnp.full((Q, K2), 2**30, jnp.int32)
        lvals = jnp.zeros((Q, K2), jnp.float32)
    else:
        sq, sd, stot, last = light_totals(
            post_doc, post_score, starts, light_dfs, weights,
            C=C, block=block, Q=Q, n_slots=n_slots,
            skip_sort="lsort" in prof_skip,
            skip_segsum="segsum" in prof_skip,
        )
        sd_clip = jnp.clip(sd, 0, n_slots - 1)
        if "hgather" in prof_skip:
            hval = jnp.zeros(sq.shape, jnp.float32)
        elif H.dtype == jnp.bfloat16:
            # 32-bit gather of the containing pair + half select (sub-word
            # gathers are the slow path — see _bf16_pair_words); pairs are
            # within a 128-lane block, so the 3D pair view is [.., .., 64]
            w = lax.bitcast_convert_type(
                H.reshape(Q, n_slots // 128, 64, 2), jnp.uint32
            )[jnp.clip(sq, 0, Q - 1), sd_clip >> 7, (sd_clip & 127) >> 1]
            half = (sd_clip & 1).astype(jnp.uint32) * jnp.uint32(16)
            hval = _bf16_hi_f32(w >> half)
        else:
            hval = H[
                jnp.clip(sq, 0, Q - 1), sd_clip >> 7, sd_clip & 127
            ].astype(jnp.float32)
        valid_last = last & (sq < Q)
        light_only = valid_last & (hval == 0.0)
        if "lcount" in prof_skip:
            found = heavy_found
        else:
            found = heavy_found + per_query_counts(sq, light_only, Q)

        # ---- candidates
        sel_score = jnp.where(valid_last, stot + hval, jnp.float32(0.0))
        if "sort2" in prof_skip:
            ldocs = jnp.full((Q, K2), 2**30, jnp.int32)
            lvals = jnp.zeros((Q, K2), jnp.float32)
        else:
            ldocs, lvals = per_query_topk_flat(
                sq, sel_score, sd, Q, K2, jnp.int32(2**30),
                quantized=fast_heavy,
            )
    # A half-width heavy pool was tried and BREAKS parity (bf16 near-tie
    # reordering needs the full K2 margin here too).
    if "cand_heavy" in prof_skip:
        hdocs = jnp.full((Q, K2), 2**30, jnp.int32)
        hvals = jnp.zeros((Q, K2), jnp.float32)
    else:
        hvals, hdocs = heavy_candidates(H, smax_sq, K2, Q, n_slots)
    if fast_heavy:
        # ONE merged K2-wide pool: top-K2 of the two pools' 2*K2 entries
        # by approximate selection score. tau = the K2-th approx value at
        # every stage a doc can be excluded (light pool, heavy pool,
        # merge); a not-full stage contributes 0 (then no positive-score
        # doc was excluded there). The guard below proves the width was
        # enough or the caller relaunches the wide exact path.
        allv = jnp.concatenate([lvals, hvals], axis=1)  # [Q, 2*K2]
        alld = jnp.concatenate([ldocs, hdocs], axis=1)
        mvals, midx = lax.top_k(allv, K2)
        cand = jnp.take_along_axis(alld, midx, axis=1)
        tau = jnp.maximum(
            jnp.maximum(lvals[:, K2 - 1], hvals[:, K2 - 1]),
            mvals[:, K2 - 1],
        )
    else:
        cand = jnp.concatenate([ldocs, hdocs], axis=1)
    cand = jnp.where(cand >= n_slots, jnp.int32(2**30), cand)

    # ---- exact rescore + canonical order + dedup
    safe_cand = jnp.clip(cand, 0, n_slots - 1)
    if "rescore" in prof_skip:
        exact = jnp.where(cand < n_slots, 1.0, 0.0).astype(jnp.float32)
    elif heavy_direct and L2 > 0 and H2 > 0:
        exact = exact_rescore_v5(
            post_doc, post_score, dense_rows, light_bucket_pos, starts,
            slot_dense, slot_light, weights, safe_cand,
            bs_steps=bs_steps, nd=nd, nl=nl, L2=L2, H2=H2,
            lb_log2=lb_log2,
        )
        exact = jnp.where(cand < n_slots, exact, jnp.float32(0.0))
    elif heavy_direct:
        # v3 retired (r4): L2 is always sized/pinned by the live callers.
        if L2 <= 0:
            raise ValueError("heavy_direct rescore requires L2 > 0")
        exact = exact_rescore_v4(
            post_doc, post_score, dense_rows, light_bucket_pos, starts,
            slot_dense, slot_light, weights, safe_cand,
            bs_steps=bs_steps, nd=nd, nl=nl, L2=L2, lb_log2=lb_log2,
        )
        exact = jnp.where(cand < n_slots, exact, jnp.float32(0.0))
    else:
        exact = exact_rescore_v2(
            post_doc, post_score, bucket_pos, light_bucket_pos, starts,
            slot_dense, slot_light, weights, safe_cand,
            bs_steps=bs_steps, nd=nd, nl=nl, lb_log2=lb_log2,
        )
        exact = jnp.where(cand < n_slots, exact, jnp.float32(0.0))
    sval, sdoc = canonical_sort(exact, safe_cand)
    sval, sdoc = _dedup_sorted(sval, sdoc)

    cols = [
        sval[:, :K],
        sdoc[:, :K].astype(jnp.float32),
        found[:, None].astype(jnp.float32),
    ]
    if fast_heavy:
        # Guard: every excluded doc's true score <= (1+eps)*tau; strict >
        # keeps boundary ties (reference breaks ties doc-ascending) on the
        # relaunch path. eps covers the TF32 product's relative error
        # (guard_eps); light selection goes through the packed-key
        # QUANTIZED sort, so it composes with that sort's score truncation
        # (2^-(23-qbits), doubled for the floor-dequant ulp): approx >=
        # true/((1+e1)(1+e2)). The bf16 H storage costs NO margin: it
        # rounds toward +inf (_round_up_store), so stored selection values
        # upper-bound the f32 accumulator.
        qbits = (Q + 1).bit_length()
        e2 = 2.0 ** -(22 - qbits)
        eps_eff = guard_eps + e2 * (1.0 + guard_eps)
        kth = sval[:, K - 1]
        ok = (kth > (1.0 + eps_eff) * tau) | (tau <= 0.0)
        cols.append(ok.astype(jnp.float32)[:, None])
    return jnp.concatenate(cols, axis=1)


_PACKED_STATICS = (
    "n_slots", "K", "K2", "C", "block", "bs_steps", "nd", "nl", "U",
    "use_compact", "heavy_direct", "fast_heavy", "guard_eps",
    "h_bf16", "lb_log2", "L2", "H2", "prof_skip",
)

bm25_search_sparse_packed = functools.partial(
    jax.jit, static_argnames=_PACKED_STATICS
)(_packed_impl)


@functools.partial(jax.jit, static_argnames=_PACKED_STATICS)
def bm25_search_sparse_packed_multi(
    post_doc: jax.Array,
    post_score: jax.Array,
    dense_rows: jax.Array,
    bucket_pos: jax.Array,
    light_bucket_pos: jax.Array,
    plans: jax.Array,  # int32 [G, 7, Q, T] — G block-diagonal sub-batches
    *,
    n_slots: int,
    K: int,
    K2: int,
    C: int,
    block: int,
    bs_steps: int,
    nd: int,
    nl: int,
    U: int,
    use_compact: bool = False,
    heavy_direct: bool = True,
    fast_heavy: bool = False,
    guard_eps: float = 2e-3,
    h_bf16: bool = False,
    lb_log2: int = LIGHT_BUCKET_LOG2,
    L2: int = 0,
    H2: int = 0,
    prof_skip: tuple = (),
):
    """G sub-batches through the packed pipeline in ONE device launch.

    A batch larger than the launch group pays one host round trip (one
    [G, 7, Q, T] int32 upload, one [G*Q, 2K+1] packed download) instead
    of G. The sub-batches stay BLOCK-DIAGONAL: each keeps its own
    compact-U heavy mix (a monolithic G*Q-query batch would reference
    more distinct heavy rows, scaling the matmul FLOPs per query), its
    own chunk budget, and its own candidate pools, so per-query device
    cost is identical to the single-batch kernel.
    """
    # Static unroll (G is small). Each group's plan is chained behind the
    # previous group's output with an optimization barrier: the groups
    # are data-independent, and without the explicit edge XLA's scheduler
    # may interleave their stages, keeping several [Q, n_slots] f32 H
    # buffers (2GB each at 1M docs) and compact tables live at once.
    # Strict serialization bounds peak device memory at one group's
    # working set.
    outs = []
    dep = None
    for g in range(plans.shape[0]):
        plan_g = plans[g]
        if dep is not None:
            plan_g, _ = lax.optimization_barrier((plan_g, dep))
        out = _packed_impl(
            post_doc, post_score, dense_rows, bucket_pos,
            light_bucket_pos, plan_g,
            n_slots=n_slots, K=K, K2=K2, C=C, block=block,
            bs_steps=bs_steps, nd=nd, nl=nl, U=U,
            use_compact=use_compact,
            heavy_direct=heavy_direct, fast_heavy=fast_heavy,
            guard_eps=guard_eps, h_bf16=h_bf16,
            lb_log2=lb_log2, L2=L2, H2=H2, prof_skip=prof_skip,
        )
        dep = out
        outs.append(out)
    return jnp.concatenate(outs, axis=0)
