"""On-device index finalization: dense rows + bucket tables from postings.

The hybrid posting representation needs three derived structures per corpus:
the heavy dense score rows (bf16 [NDpad, n_slots]), the heavy bucket-
position table (int32 [NDpad, NBh+1]) and the light bucket-position table
(int32 [NL+1, NBl+1]). Building them host-side at 1M-doc scale materializes
a 12GB f32 matrix and ships ~6.6GB through the host->device link.
All three are pure functions of the (already device-resident) posting arrays
plus a few KB of per-row (start, df) metadata, so this module computes them
on device instead: expand per-row posting ranges with a searchsorted-over-
cumsum (the same trick ops/bm25.expand_chunks uses), then scatters; the
upload shrinks to the posting arrays the index needs anyway.

The dense scatter runs GROUP-WISE (<=512 rows per program, one compiled
shape reused for every group) and the groups are concatenated on device,
which bounds the scatter's planned operand buffer (XLA may promote a bf16
scatter operand to f32 and pad it) to one group's slice.

Padding entries use out-of-bounds row ids; JAX's default scatter semantics
drop out-of-bounds updates, so no sacrificial row is needed.

Returns match the host path bit-for-bit: dense values are the f32 eager
scores cast to bf16 (round-to-nearest-even both sides), bucket positions
are prefix sums of bucket occupancy counts = np.searchsorted of the bucket
bounds. A regression test asserts equality against the host builder.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from ..ops.bm25_sparse import BUCKET_LOG2, LIGHT_BUCKET_LOG2


def _expand_rows(row_starts, row_dfs, row_ids, total_pad, oob_row, P,
                 n_slots, post_doc):
    """Per-posting (row id, posting pos, doc, valid) for concatenated
    per-ENTRY ranges [start_e, start_e + df_e), padded to total_pad.
    row_ids maps each entry to its target row — entries may be
    many-to-one (merged multi-segment dense rows scatter one entry per
    (term, segment) occurrence into one shared row). Padding entries
    carry row id `oob_row` (out of bounds -> scatter drops them)."""
    cum = jnp.cumsum(row_dfs)
    total = cum[-1]
    iota = lax.broadcasted_iota(jnp.int32, (total_pad,), 0)
    row = jnp.searchsorted(cum, iota, side="right").astype(jnp.int32)
    rown = jnp.clip(row, 0, max(row_dfs.shape[0] - 1, 0))
    within = iota - (cum[rown] - row_dfs[rown])
    pos = jnp.clip(row_starts[rown] + within, 0, max(P - 1, 0))
    valid = iota < total
    doc = jnp.clip(post_doc[pos], 0, n_slots - 1)
    srow = jnp.where(valid, row_ids[rown], oob_row)
    return srow, pos, doc, valid


@functools.partial(
    jax.jit,
    static_argnames=("n_rows_pad", "n_slots", "total_pad", "bucket_log2"),
)
def _build_buckets(
    post_doc,
    row_starts,
    row_dfs,
    row_ids,
    *,
    n_rows_pad: int,
    n_slots: int,
    total_pad: int,
    bucket_log2: int,
):
    """(bucket_pos int32 [n_rows_pad, NB+1], max bucket occupancy int32)."""
    nb = (n_slots + (1 << bucket_log2) - 1) >> bucket_log2
    P = post_doc.shape[0]
    srow, _pos, doc, _valid = _expand_rows(
        row_starts, row_dfs, row_ids, total_pad, n_rows_pad, P, n_slots,
        post_doc,
    )
    cnt = jnp.zeros((n_rows_pad, nb), jnp.int32)
    cnt = cnt.at[srow, doc >> bucket_log2].add(1, mode="drop")
    bucket_pos = jnp.concatenate(
        [jnp.zeros((n_rows_pad, 1), jnp.int32), jnp.cumsum(cnt, axis=1)],
        axis=1,
    )
    return bucket_pos, jnp.max(cnt)


@functools.partial(
    jax.jit,
    static_argnames=("g_rows", "n_slots", "total_pad", "dtype", "three_d"),
)
def _scatter_dense_group(
    post_doc,
    post_score,
    group_starts,  # int32 [g_ents] (df 0 entries are no-ops)
    group_dfs,
    group_rows,  # int32 [g_ents] group-LOCAL target row per entry
    *,
    g_rows: int,
    n_slots: int,
    total_pad: int,
    dtype,
    three_d: bool = False,
):
    """One group's dense rows via scatter (<=512 rows per call: XLA plans
    the scatter operand padded — and f32-promoted for bf16 — so a whole-
    table scatter fails compilation at multi-GB budgets; the group slice
    keeps the planned buffer ~2.5 GB).

    three_d stores [g_rows, n_slots/128, 128] — the layout sparse mode
    keeps the table in (ops/heavy.heavy_fused3_xla)."""
    P = post_doc.shape[0]
    srow, pos, doc, valid = _expand_rows(
        group_starts, group_dfs, group_rows, total_pad, g_rows, P, n_slots,
        post_doc,
    )
    score = jnp.where(valid, post_score[pos], jnp.float32(0.0))
    if three_d:
        dense = jnp.zeros((g_rows, n_slots // 128, 128), dtype)
        return dense.at[srow, doc >> 7, doc & 127].set(
            score.astype(dtype), mode="drop"
        )
    dense = jnp.zeros((g_rows, n_slots), dtype)
    return dense.at[srow, doc].set(score.astype(dtype), mode="drop")


@functools.partial(jax.jit, donate_argnums=(0,))
def _write_block(dense, blk, base):
    """Write one group block into the (donated) full table in place.

    The old allocate-per-group + concatenate shape had a 2x-table
    transient peak at the lazy sync point — a 7 GiB dense budget was the
    OOM ceiling on a 16 GiB chip. Donation is honored on this backend
    (probed: three in-place updates on one 9.5 GiB buffer), so the peak
    is now table + one ~2.5 GB group block."""
    return lax.dynamic_update_slice_in_dim(dense, blk, base, axis=0)


def _round_pad(n: int, m: int = 1 << 20) -> int:
    return max(((n + m - 1) // m) * m, m)


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def build_heavy_on_device(post_doc, post_score, starts, dfs, *, rows=None,
                          n_rows_pad, n_slots, bf16: bool,
                          with_buckets: bool = True,
                          three_d: bool = False):
    """Dense rows (+ heavy bucket table when with_buckets) on device.

    starts/dfs: host int arrays, one SCATTER ENTRY each. rows maps each
    entry to its target dense row (ascending), many-to-one for merged
    multi-segment rows (one entry per (term, segment) occurrence); None
    means entry i targets row i. Returns dense with >= n_rows_pad rows
    (rounded up to the group grid; the extra rows are zero — the heavy
    kernel sizes its mix operand from dense.shape[0], and the sentinel
    row id n_dense stays all-zero).
    """
    import numpy as np

    dt = jnp.bfloat16 if bf16 else jnp.float32
    nb = (n_slots + (1 << BUCKET_LOG2) - 1) >> BUCKET_LOG2
    dshape = (
        (n_rows_pad, n_slots // 128, 128) if three_d
        else (n_rows_pad, n_slots)
    )
    if dfs.size == 0:
        return (
            jnp.zeros(dshape, dt),
            jnp.zeros((n_rows_pad, nb + 1), jnp.int32)
            if with_buckets
            else None,
            0,
        )
    if rows is None:
        rows = np.arange(len(dfs), dtype=np.int64)
    else:
        rows = np.asarray(rows, np.int64)
        assert (np.diff(rows) >= 0).all(), "entry rows must be ascending"
    total_pad = _round_pad(int(dfs.sum()))
    d_starts = jnp.asarray(starts, jnp.int32)
    d_dfs = jnp.asarray(dfs, jnp.int32)

    # Group grid: <=512 rows per scatter call; every group reuses one
    # compiled shape (entry capacity and expansion padded to the max
    # group) and scatters into ONE donated table allocation.
    n_groups = max(1, -(-n_rows_pad // 512))
    g_rows = _round_up(-(-n_rows_pad // n_groups), 8)
    g_lo = np.searchsorted(rows, np.arange(n_groups + 1) * g_rows, "left")
    e_cap = max(1, int(np.diff(g_lo).max()))
    g_total = _round_pad(
        max(
            (int(dfs[int(g_lo[g]):int(g_lo[g + 1])].sum())
             for g in range(n_groups)),
            default=1,
        )
    )
    # allocate the FULL table once, oversized to the group grid so every
    # block write is a full g_rows slice (extra rows stay zero; the heavy
    # kernel sizes its mix operand from dense.shape[0])
    full_rows = n_groups * g_rows
    dshape = (
        (full_rows, n_slots // 128, 128) if three_d
        else (full_rows, n_slots)
    )
    dense = jnp.zeros(dshape, dt)
    for g in range(n_groups):
        lo, hi = int(g_lo[g]), int(g_lo[g + 1])
        gs = np.zeros(e_cap, np.int64)
        gd = np.zeros(e_cap, np.int64)
        gr = np.full(e_cap, g_rows, np.int64)  # pad -> oob, dropped
        gs[: hi - lo] = starts[lo:hi]
        gd[: hi - lo] = dfs[lo:hi]
        gr[: hi - lo] = rows[lo:hi] - g * g_rows
        blk = _scatter_dense_group(
            post_doc, post_score,
            jnp.asarray(gs, jnp.int32), jnp.asarray(gd, jnp.int32),
            jnp.asarray(gr, jnp.int32),
            g_rows=g_rows, n_slots=n_slots, total_pad=g_total,
            dtype=dt, three_d=three_d,
        )
        dense = _write_block(dense, blk, g * g_rows)
    bucket_pos = None
    occ = 0
    if with_buckets:
        bucket_pos, occ_dev = _build_buckets(
            post_doc, d_starts, d_dfs, jnp.asarray(rows, jnp.int32),
            n_rows_pad=n_rows_pad, n_slots=n_slots, total_pad=total_pad,
            bucket_log2=BUCKET_LOG2,
        )
        occ = int(occ_dev)
    return dense, bucket_pos, occ


@functools.partial(jax.jit, static_argnames=("k", "n_slots"))
def _row_topk_group(rows3, *, k: int, n_slots: int):
    """Exact canonical top-k per dense row, block-prefiltered.

    The old full 2-key sort of every 1M-lane row was the dominant
    row-topk build cost (measured ~60s for 256 rows at 1M slots). Exact
    two-phase replacement: order the 128-lane blocks by (block max desc,
    block id asc) and keep the first k — any unpicked block's lanes lose
    to one distinct lane per picked block (a strictly higher max, or an
    equal max in a lower block whose slots are all smaller), so the
    canonical top-k lives inside the picked blocks. Then one 2-key sort
    by (score desc, slot asc) over the k*128 candidate lanes reproduces
    the full sort's prefix bit-for-bit (same tie rule, candidate
    superset). Sort volume per row: n_slots/128 + k*128 instead of
    n_slots (~50x less at 1M)."""
    g, nblk, _ = rows3.shape
    kb = min(k, nblk)
    bm = jnp.max(rows3, axis=2)  # [g, nblk]
    iota_b = lax.broadcasted_iota(jnp.int32, (g, nblk), 1)
    _snb, sbi = lax.sort((-bm, iota_b), dimension=1, num_keys=2)
    blocks = sbi[:, :kb]  # [g, kb], canonical block order
    cand = jnp.take_along_axis(rows3, blocks[:, :, None], axis=1)
    lane = lax.broadcasted_iota(jnp.int32, (g, kb, 128), 2)
    slots = (blocks[:, :, None] * 128 + lane).reshape(g, kb * 128)
    flat = cand.reshape(g, kb * 128)
    sneg, sidx = lax.sort((-flat, slots), dimension=1, num_keys=2)
    k = min(k, kb * 128)
    return -sneg[:, :k], sidx[:, :k]


def build_row_topk_on_device(dense_rows3, n_rows: int, *, k: int,
                             n_slots: int, group: int = 64):
    """Host (vals f32 [n_rows, k], slots int32 [n_rows, k]) for the first
    n_rows of the 3D dense table, each row's exact canonical top-k.

    Row i of the table is the i-th highest-df heavy term (build order),
    so callers cap n_rows to the df head — the full per-row sort is the
    build-time cost bound."""
    import numpy as np

    if n_rows <= 0 or k <= 0:
        return (
            np.zeros((0, max(k, 1)), np.float32),
            np.zeros((0, max(k, 1)), np.int32),
        )
    vals = []
    slots = []
    group = min(group, dense_rows3.shape[0])
    for lo in range(0, n_rows, group):
        hi = min(lo + group, n_rows)
        g = hi - lo
        blk = lax.dynamic_slice_in_dim(dense_rows3, lo, group, axis=0)
        v, s = _row_topk_group(blk, k=k, n_slots=n_slots)
        vals.append(v[:g])
        slots.append(s[:g])
    v, s = jax.device_get((jnp.concatenate(vals), jnp.concatenate(slots)))
    return np.asarray(v, np.float32), np.asarray(s, np.int32)


def build_light_on_device(post_doc, starts, dfs, *, n_rows_pad, n_slots,
                          bucket_log2=LIGHT_BUCKET_LOG2):
    """Light bucket-position table on device (no dense materialization).

    bucket_log2 may be coarser than the default when the row count makes
    the table exceed its HBM budget (DeviceIndex adaptive granularity)."""
    nb = (n_slots + (1 << bucket_log2) - 1) >> bucket_log2
    if dfs.size == 0:
        return jnp.zeros((n_rows_pad, nb + 1), jnp.int32), 0
    bucket_pos, occ = _build_buckets(
        post_doc,
        jnp.asarray(starts, jnp.int32),
        jnp.asarray(dfs, jnp.int32),
        jnp.arange(len(dfs), dtype=jnp.int32),
        n_rows_pad=n_rows_pad,
        n_slots=n_slots,
        total_pad=_round_pad(int(dfs.sum())),
        bucket_log2=bucket_log2,
    )
    return bucket_pos, int(occ)
