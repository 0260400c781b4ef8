"""DeviceIndex: HBM-resident multi-segment BM25 index + batched query planner.

The reference's Segment keeps the lexicon in RAM and postings behind open file
handles (src/api_segment.cpp:70-102); a DeviceIndex instead concatenates every
segment's postings into flat device arrays with *global* doc slots:

    post_doc   int32 [P]  global doc slot (= segment doc base + local docId)
    post_score f32  [P]   eager BM25 contribution (index/builder.py)

Per-segment lexicons stay host-side as dicts term -> (global posting start,
df). A query is planned host-side into fixed-shape (starts, dfs, weights)
term-slot arrays — slots are ordered term-major with segments ascending, so
per-document f32 accumulation order equals the C++ engine's segment-outer/
term-inner loop (each doc only ever receives contributions from its own
segment) — then executed by ops/bm25.py in one batched kernel launch.

Shape bucketing keeps jit recompiles bounded: the query batch, term-slot, and
k axes are padded to a small set of static sizes.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import DEFAULT_CONFIG, EngineConfig
from .builder import SegmentArrays, eager_scores

WeightedTerm = Tuple[str, float]


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1] if n <= buckets[-1] else n


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _deal_sorted(order: np.ndarray, g: int) -> np.ndarray:
    """Deal a sorted query order round-robin into the multi-launch groups.

    `order` is the window-sorted index order; the group path slices the
    permuted list into consecutive blocks of `g` (last block = remainder).
    Dealing assigns sorted element i to the next non-full group in
    rotation, so each group's block stays internally sorted (a stride of
    a sorted list is sorted — the selection kernel's clustering invariant)
    while window/posting mass balances across groups. Without this the
    global sort concentrates the big windows into the LAST group and its
    inflated C/L2 budgets tax every group (all groups share one kernel
    shape, the max over groups)."""
    nq = int(order.shape[0])
    gn = -(-nq // g)
    sizes = [g] * (gn - 1) + [nq - g * (gn - 1)]
    groups: list = [[] for _ in range(gn)]
    j = 0
    for idx in order:
        while len(groups[j % gn]) >= sizes[j % gn]:
            j += 1
        groups[j % gn].append(idx)
        j += 1
    return np.concatenate(
        [np.asarray(gq, dtype=order.dtype) for gq in groups]
    )


def _pick_shape(
    n: int,
    buckets: Sequence[int],
    pin: Optional[int] = None,
    warn_tag: str = "",
) -> int:
    """Static kernel shape for a batch-varying size.

    pinned: return the pin; overflow escapes to the next multiple of the
    pin (bounded distinct shapes) with a warning — recompile flapping
    mid-serving is THE throughput killer (every flapping batch pays a full
    XLA compile), so escapes must be rare and loud.
    unpinned: bucket ladder; overflow past the ladder rounds up to
    multiples of the LARGEST bucket (previously the smallest, which
    generated unboundedly many shapes just past the ladder).
    """
    n = max(n, 1)
    if pin:
        if n <= pin:
            return pin
        v = _round_up(n, pin)
        if warn_tag:
            from ..utils.logging import log

            log(
                "shapes",
                f"{warn_tag}={n} exceeds pinned {pin}; compiling a "
                f"{v}-shape escape (expect a one-time XLA compile)",
                level="warning",
            )
        return v
    # NB: must compare against the LADDER TOP, not _bucket's return —
    # _bucket returns raw n past the ladder, so `n > b` was dead code and
    # every off-ladder size compiled its own shape. Measured in serving:
    # engine cache hits shrink each batch's pending count differently
    # (512 -> 460 -> 422 -> ...), and each count became a fresh ~25s XLA
    # compile of the packed kernel.
    if n > buckets[-1]:
        return _round_up(n, buckets[-1])
    return _bucket(n, buckets)


_EMPTY_I64 = np.empty(0, np.int64)
_EMPTY_F32 = np.empty(0, np.float32)


def _ranges(counts: np.ndarray) -> np.ndarray:
    """Concatenated [0..c) ranges for each c in counts (vectorized)."""
    total = int(counts.sum())
    if total == 0:
        return _EMPTY_I64
    out = np.arange(total, dtype=np.int64)
    ends = np.cumsum(counts)
    out -= np.repeat(ends - counts, counts)
    return out


def _probe_queries(slices, queries):
    """Per query: merged-lexicon row indices + repeated weights.

    One _lex_slices dict probe per (query, term); occurrences expand to
    consecutive table rows via np.repeat + _ranges. Shared by every
    planner (single-device and sharded, fused and sparse).
    """
    q_rows: List[np.ndarray] = []
    q_ws: List[np.ndarray] = []
    for terms in queries:
        offs: List[int] = []
        cnts: List[int] = []
        ws: List[float] = []
        for term, w in terms:
            oc = slices.get(term)
            if oc is not None:
                offs.append(oc[0])
                cnts.append(oc[1])
                ws.append(w)
        if offs:
            cnts_a = np.asarray(cnts, np.int64)
            q_rows.append(
                np.repeat(np.asarray(offs, np.int64), cnts_a)
                + _ranges(cnts_a)
            )
            q_ws.append(np.repeat(np.asarray(ws, np.float32), cnts_a))
        else:
            q_rows.append(_EMPTY_I64)
            q_ws.append(_EMPTY_F32)
    return q_rows, q_ws


def _probe_queries_flat(slices, queries):
    """Flat variant of _probe_queries for the serving-path planner: one
    dict probe per (query, term), ONE numpy expansion for the whole batch
    (the per-query list-of-arrays variant costs ~10 small numpy calls per
    query — ~20 ms of serial host time at batch 512, measured).

    Returns (rows_flat int64, ws_flat f32, q_lens int64[len(queries)]):
    merged-table row ids and weights in (query, term-occurrence) order,
    plus per-query row counts.
    """
    offs: List[int] = []
    cnts: List[int] = []
    ws: List[float] = []
    q_lens = np.zeros(len(queries), np.int64)
    for qi, terms in enumerate(queries):
        tot = 0
        for term, w in terms:
            oc = slices.get(term)
            if oc is not None:
                offs.append(oc[0])
                cnts.append(oc[1])
                ws.append(w)
                tot += oc[1]
        q_lens[qi] = tot
    cnts_a = np.asarray(cnts, np.int64)
    rows = np.repeat(np.asarray(offs, np.int64), cnts_a) + _ranges(cnts_a)
    ws_flat = np.repeat(np.asarray(ws, np.float32), cnts_a)
    return rows, ws_flat, q_lens


@dataclass
class QueryResult:
    """One query's hits as global doc slots (segment/docId via locate())."""

    scores: np.ndarray  # f32 [<=k]
    doc_slots: np.ndarray  # int32 [<=k]
    found: int



def _log_build_phases(phases) -> None:
    """One-line cold-start attribution (VERDICT r3 item 5)."""
    from ..utils.logging import log

    log("build", "phases: " + " ".join(
        f"{n}={s:.1f}s" for n, s in phases if s >= 0.05
    ))


class DeviceIndex:
    """Immutable multi-segment index resident in device memory."""

    T_BUCKETS = (4, 8, 16, 32, 64, 128, 256)
    Q_BUCKETS = (1, 8, 16, 32, 64, 128)
    K_BUCKETS = (10, 32, 100)
    # Static compact light-pair count for the v4 rescore (live light
    # (query, slot) pairs per launch; pinned like C).
    L_BUCKETS = (128, 256, 512, 1024, 2048, 4096, 8192)
    # Static compact heavy-pair count for the v5 rescore (live heavy
    # (query, slot) pairs per launch; pinned like L).
    HP_BUCKETS = (128, 256, 512, 1024, 2048, 4096, 8192)
    # Selection-window envelope: max entries of one query's contiguous run
    # of the flat light array = that query's summed light dfs, pinned from
    # the probed workload (p100 of probe batches). No kernel reads it yet
    # (ROADMAP: a per-query selection kernel would).
    W_BUCKETS = (512, 1024, 2048, 4096, 8192, 16384, 32768)

    def __init__(
        self,
        segments: Sequence[SegmentArrays],
        seg_names: Optional[Sequence[str]] = None,
        config: EngineConfig = DEFAULT_CONFIG,
        device=None,
        host_only: bool = False,
    ):
        """host_only=True builds only the planning state (lexicons, dense
        row assignment, merged lex table) — no dense-row materialization,
        bucket tables, or device transfers. Planning-only probes (e.g.
        bench.py's chunk-budget sizing) run in seconds instead of minutes
        at 1M-doc scale; search_batch* is unavailable."""
        import jax
        import jax.numpy as jnp

        # Cold-start attribution: one log line with per-phase seconds
        # (VERDICT r3 item 5 — the 354s-vs-1225s build spread needs a
        # breakdown, not a guess).
        import time as _time

        _phases: List[Tuple[str, float]] = []
        _t_last = [_time.perf_counter()]

        def _tick(name: str) -> None:
            now = _time.perf_counter()
            _phases.append((name, now - _t_last[0]))
            _t_last[0] = now

        self.host_only = host_only
        self.config = config
        # Pinned static shapes (pin_shapes): {"T","Q","C","U"} -> int.
        self._pins: Dict[str, int] = {}
        # Per-Q-envelope pins (pin_shapes(scope_q=True)): Q envelope ->
        # {"T","C","U","W"}. A mixed-batch-size server (the batching queue
        # emits whatever coalesced) pins each Q bucket to its own probed
        # envelope instead of padding every 1-query request to the
        # max-batch C/U/W — scoped pins win over the global ones.
        self._qpins: Dict[int, Dict[str, int]] = {}
        # (term, k) -> QueryResult|None for w==1 1-term shortcut answers
        self._shortcut_memo: Dict = {}
        # Serving-visible guard-trip accounting (bench/probes read these).
        self.rescue_ms = 0.0
        self.rescue_trips = 0
        # (terms tuple, K) -> QueryResult: known guard-trippers answered
        # host-side on recurrence (see _host_rescue_row)
        self._rescue_memo: Dict = {}
        self.segments = list(segments)
        self.seg_names = list(seg_names) if seg_names else [
            f"seg_{i + 1:06d}" for i in range(len(self.segments))
        ]
        assert len(self.seg_names) == len(self.segments)

        # Global doc slot layout: segments concatenated in order.
        self.doc_bases: List[int] = []
        base = 0
        for seg in self.segments:
            self.doc_bases.append(base)
            base += seg.N
        self.n_docs = base
        # sparse mode tiles the doc axis in 2048-doc count tiles
        # (ops/heavy.TILE); keep n_slots aligned to both.
        pad = config.device.doc_pad
        if config.device.mode == "sparse":
            # round_up, not max: a doc_pad of e.g. 3072 must still give a
            # 2048-aligned n_slots (heavy kernels tile the doc axis).
            pad = _round_up(pad, 2048)
        self.n_slots = max(_round_up(base, pad), pad)
        # The fused packed launch transports doc slots / found counts as
        # exact f32 values (an accelerator may flush denormal bit-patterns,
        # so bitcast packing is off the table); f32 is exact only below
        # 2^24.
        if self.n_slots >= 1 << 24:
            raise ValueError(
                f"DeviceIndex supports < 2^24 doc slots per chip "
                f"(got {self.n_slots}); shard over a mesh (ShardedIndex) "
                f"for larger corpora"
            )

        # Host lexicons: term -> (global posting start, df, dense_row_id)
        # per segment. Terms with df >= dense threshold additionally get a
        # precomputed dense score row (hybrid posting representation): their
        # query-time contribution becomes one matmul instead of a
        # scatter over a huge posting list.
        dcfg = config.device
        self.dense_threshold = (
            max(1, int(self.n_slots * dcfg.dense_df_ratio))
            if dcfg.dense_df_ratio > 0
            else (1 << 62)
        )

        # Merged heavy rows (multi-segment): classify heavy terms by
        # GLOBAL df and scatter every segment's postings for the term into
        # ONE dense row. Per-(term, segment) rows made a 4-segment 1M
        # corpus cost ~4x the single-segment headline (4x term slots, 4x
        # dense rows/matmul FLOPs, and — worst — the dense threshold
        # applied to PER-SEGMENT df, reclassifying Zipf mid-df terms as
        # light and quintupling the chunk budget). Bit-exact: a doc lives
        # in exactly ONE segment, query weights are per-term, and the other segments
        # contribute literal +0.0f at its slot, which f32 addition drops
        # (scores are never -0.0). Requires the direct heavy rescore
        # (the heavy-direct rescore reads scores off the merged row); the bf16-
        # rows opt-in keeps per-(term, segment) rows because its v2
        # rescore binary-searches one contiguous posting range per slot.
        self._sparse = dcfg.mode == "sparse"
        self._heavy_direct = not dcfg.dense_rows_bf16
        self._merged_heavy = (
            self._sparse
            and self._heavy_direct
            and len(self.segments) > 1
        )

        self.lex: List[Dict[str, Tuple[int, int, int]]] = []
        post_doc_parts: List[np.ndarray] = []
        post_score_parts: List[np.ndarray] = []
        heavy: List[Tuple[int, int, int, int]] = []  # (df, seg_idx, term_i, start)
        gdf: Dict[str, int] = {}  # global df per term (merged mode)
        self._seg_pbase: List[int] = []  # global posting base per segment
        pbase = 0
        for seg_i, (seg, dbase) in enumerate(zip(self.segments, self.doc_bases)):
            self._seg_pbase.append(pbase)
            lex: Dict[str, Tuple[int, int, int]] = {}
            offs = seg.term_offsets
            for i, t in enumerate(seg.terms):
                df = int(seg.term_df[i])
                start = pbase + int(offs[i])
                lex[t] = (start, df, -1)
                if self._merged_heavy:
                    if df > 0:
                        gdf[t] = gdf.get(t, 0) + df
                elif df >= self.dense_threshold:
                    heavy.append((df, seg_i, i, start))
            self.lex.append(lex)
            post_doc_parts.append(seg.post_doc.astype(np.int64) + dbase)
            score = seg.post_score
            if score is None:
                score = eager_scores(seg, k1=config.bm25.k1, b=config.bm25.b)
            post_score_parts.append(score)
            pbase += seg.num_postings
        self.n_postings = pbase
        _tick("lexicons")

        # Highest-df terms win the capped dense-row budget.
        row_bytes = (2 if dcfg.dense_rows_bf16 else 4) * self.n_slots
        row_cap = min(
            dcfg.dense_max_rows,
            max(0, int(dcfg.dense_max_bytes // row_bytes)),
        )
        # Over-threshold terms dropped by the row cap stay light; they get
        # light bucket rows like any other light term, so the measured
        # bucket occupancy (_bs_depth) covers them automatically.
        # heavy_entries: (row_id, seg_i, term_i) scatter units — one per
        # (heavy term, segment) occurrence, many-to-one onto merged rows.
        self._gdf: Dict[str, int] = {}
        if self._merged_heavy:
            heavy_terms = sorted(
                ((d, t) for t, d in gdf.items() if d >= self.dense_threshold),
                reverse=True,
            )[:row_cap]
            self.n_dense = len(heavy_terms)
            self._gdf = {t: d for d, t in heavy_terms}
            heavy_entries: List[Tuple[int, int, int]] = []
            for row_id, (_d, t) in enumerate(heavy_terms):
                for seg_i, seg in enumerate(self.segments):
                    v = self.lex[seg_i].get(t)
                    if v is not None and v[1] > 0:
                        heavy_entries.append((row_id, seg_i, t))
                        self.lex[seg_i][t] = (v[0], v[1], row_id)
        else:
            heavy.sort(reverse=True)
            heavy = heavy[:row_cap]
            self.n_dense = len(heavy)
        # Rows padded to a multiple of 8 past the zero row (aligned matmul
        # operand for the heavy step, ops/heavy.py).
        nd1_pad = _round_up(self.n_dense + 1, 8)
        # Sparse mode finalizes the dense rows + bucket tables ON DEVICE
        # (index/device_build.py): they are pure functions of the posting
        # arrays, and scattering ~30M updates on device beats materializing
        # a 12GB host matrix and shipping 6.6GB over the host->device
        # link.
        device_build = not host_only and (
            os.environ.get("NEXTSEARCH_DEVICE_BUILD", "1") == "1"
        )
        self._device_build = device_build
        dense_host = (
            None
            if host_only or device_build
            else np.zeros((nd1_pad, self.n_slots), np.float32)
        )
        # Sparse rescore bucket-position tables (ops/bm25_sparse.py
        # exact_rescore_v2): first-posting offset per doc-slot bucket, so a
        # candidate's binary search covers one bucket's occupancy instead of
        # the term's full df. Heavy rows use fine 2^BUCKET_LOG2-slot buckets
        # (dense rows can be nearly full); light terms get their own table
        # at coarse 2^LIGHT_BUCKET_LOG2 granularity below. The search depth
        # (_bs_depth) is the measured max occupancy of either table.
        from ..ops.bm25_sparse import BUCKET_LOG2, LIGHT_BUCKET_LOG2

        # Heavy bucket positions exist ONLY for the bf16-rows opt-in: with
        # f32 rows the rescore reads a candidate's exact heavy score
        # straight off the dense table (the v4/v5 heavy-direct rescore), so the ~1GB
        # heavy table would be dead weight.
        nb = (self.n_slots + (1 << BUCKET_LOG2) - 1) >> BUCKET_LOG2
        bucket_host = (
            np.zeros((nd1_pad, nb + 1), np.int32)
            if self._sparse and not host_only and not device_build
            and not self._heavy_direct
            else None
        )
        bounds = (np.arange(nb + 1, dtype=np.int64) << BUCKET_LOG2)
        heavy_max_occ = 0
        if self._merged_heavy:
            # bucket_host is None by construction (merged requires
            # _heavy_direct); only the dense scatter runs host-side.
            if not host_only and not device_build:
                for row_id, seg_i, t in heavy_entries:
                    start_g, dfv, _r = self.lex[seg_i][t]
                    lo = start_g - self._seg_pbase[seg_i]
                    docs = post_doc_parts[seg_i][lo : lo + dfv]
                    dense_host[row_id, docs] = post_score_parts[seg_i][
                        lo : lo + dfv
                    ]
        else:
            for row_id, (df, seg_i, term_i, _start) in enumerate(heavy):
                seg = self.segments[seg_i]
                if not host_only and not device_build:
                    lo = int(seg.term_offsets[term_i])
                    hi = int(seg.term_offsets[term_i + 1])
                    score = post_score_parts[seg_i]
                    docs = (
                        seg.post_doc[lo:hi].astype(np.int64)
                        + self.doc_bases[seg_i]
                    )
                    dense_host[row_id, docs] = score[lo:hi]
                    if bucket_host is not None:
                        row = np.searchsorted(
                            docs, bounds, side="left"
                        ).astype(np.int32)
                        bucket_host[row_id] = row
                        heavy_max_occ = max(
                            heavy_max_occ, int(np.diff(row).max())
                        )
                term = seg.terms[term_i]
                start, dfv, _ = self.lex[seg_i][term]
                self.lex[seg_i][term] = (start, dfv, row_id)
        # Light bucket-position table: one row per light (term, segment)
        # lexicon entry, giving the first-posting offset (relative to the
        # entry's posting start) of every 2^LIGHT_BUCKET_LOG2-doc-slot
        # bucket. Row ids are recorded per segment for _build_merged_lex;
        # the final row (id n_light) is the all-zeros sentinel for heavy/
        # padding slots. Occupancy is measured so the rescore depth is the
        # true max bucket size, not a df bound.
        self._light_row: List[Dict[str, int]] = []
        light_host = None
        light_max_occ = 0
        self.n_light = 0
        # Adaptive bucket granularity: the light table is
        # (n_light + 1) x (n_slots >> lb_log2 + 2) int32, and n_light
        # scales with segments x vocabulary — a 4-segment merge over the
        # 200k-term corpus (~790k light rows) needs 6.2GB at the default
        # 2^9 granularity and OOMs HBM next to the dense rows. Coarsen
        # until the table fits the budget; the only cost is a deeper
        # rescore binary search (depth = measured occupancy bit length).
        self._lb_log2 = LIGHT_BUCKET_LOG2
        if self._sparse and not host_only:
            n_light_est = sum(
                int((seg.term_df > 0).sum()) for seg in self.segments
            ) - (len(heavy_entries) if self._merged_heavy else self.n_dense)
            budget = int(
                os.environ.get("NEXTSEARCH_LIGHT_TABLE_BYTES", 2 << 30)
            )
            while (
                self._lb_log2 < 14
                and (n_light_est + 1)
                * ((self.n_slots >> self._lb_log2) + 2)
                * 4
                > budget
            ):
                self._lb_log2 += 1
            if self._lb_log2 != LIGHT_BUCKET_LOG2:
                from ..utils.logging import log

                log(
                    "index",
                    f"light bucket granularity coarsened to "
                    f"2^{self._lb_log2} ({n_light_est} light rows; table "
                    f"budget {budget >> 20} MiB)",
                )
        # Light-table build path: the table is a per-posting histogram +
        # cumsum — one core of numpy bincount does the 50M-posting 1M-doc
        # corpus in seconds and the int32 table (1.6GB) ships in one
        # upload, while the device path is a scatter-add per posting plus
        # a cumsum over the whole table. Device path kept for environments
        # with a slow host->device link; neither is measured on the GPU.
        light_host_build = (
            os.environ.get("NEXTSEARCH_LIGHT_BUILD", "host") == "host"
        )
        if self._sparse and not host_only:
            build_tables = not device_build or light_host_build
            nbl = (
                self.n_slots + (1 << self._lb_log2) - 1
            ) >> self._lb_log2
            counts_parts: List[np.ndarray] = []
            base_row = 0
            for seg_i, seg in enumerate(self.segments):
                lex = self.lex[seg_i]
                dense_ids = np.full(len(seg.terms), -1, np.int64)
                for t_i, t in enumerate(seg.terms):
                    dense_ids[t_i] = lex[t][2]
                mask = (seg.term_df > 0) & (dense_ids < 0)
                lt_idx = np.nonzero(mask)[0]
                term_row = np.full(len(seg.terms), -1, np.int64)
                term_row[lt_idx] = base_row + np.arange(lt_idx.shape[0])
                self._light_row.append(
                    {seg.terms[i]: int(term_row[i]) for i in lt_idx}
                )
                if lt_idx.shape[0] and build_tables:
                    row_of_post = np.repeat(
                        term_row - base_row, seg.term_df.astype(np.int64)
                    )
                    valid = row_of_post >= 0
                    bucket = (
                        post_doc_parts[seg_i][valid] >> self._lb_log2
                    )
                    # (row, bucket) keys are globally NON-DECREASING (rows
                    # ascend in term order, postings are doc-ascending
                    # within a row), so per-cell counts are run lengths —
                    # one diff + one unique-key assignment instead of
                    # bincount's 50M scattered increments into a multi-GB
                    # int64 buffer (measured 25s -> ~5s at 1M docs).
                    ncell = lt_idx.shape[0] * nbl
                    kdt = np.int32 if ncell < (1 << 31) else np.int64
                    key = (
                        row_of_post[valid].astype(kdt) * kdt(nbl)
                        + bucket.astype(kdt)
                    )
                    cnt = np.zeros(ncell, np.int32)
                    if key.size:
                        change = np.flatnonzero(key[1:] != key[:-1])
                        starts_u = np.concatenate(([0], change + 1))
                        ends_u = np.concatenate((change + 1, [key.size]))
                        cnt[key[starts_u]] = (
                            ends_u - starts_u
                        ).astype(np.int32)
                    counts_parts.append(cnt.reshape(lt_idx.shape[0], nbl))
                base_row += lt_idx.shape[0]
            self.n_light = base_row
            if build_tables:
                light_host = np.zeros((base_row + 1, nbl + 1), np.int32)
                if counts_parts:
                    counts = np.concatenate(counts_parts, axis=0)
                    light_max_occ = int(counts.max(initial=0))
                    np.cumsum(
                        counts, axis=1, out=light_host[:base_row, 1:]
                    )
        self._bs_depth = max(
            2, int(max(heavy_max_occ, light_max_occ, 1)).bit_length()
        )
        _tick("light_rows")

        post_doc = (
            np.concatenate(post_doc_parts).astype(np.int32)
            if post_doc_parts
            else np.zeros(1, np.int32)
        )
        post_score = (
            np.concatenate(post_score_parts).astype(np.float32)
            if post_score_parts
            else np.zeros(1, np.float32)
        )
        if post_doc.size == 0:
            post_doc = np.zeros(1, np.int32)
            post_score = np.zeros(1, np.float32)

        self._device = device
        if host_only:
            self.post_doc = None
            self.post_score = None
            self.dense_rows = None
            self.bucket_pos = None
            self.light_bucket_pos = None
            self._row_topk = None
            self._light_topk = None
            self._build_merged_lex()
            return
        put = (lambda x: jax.device_put(x, device)) if device is not None else jnp.asarray
        self.post_doc = put(post_doc)
        self.post_score = put(post_score)
        self.post_doc.block_until_ready()
        _tick("postings_upload")
        if device_build:
            from .device_build import (
                build_heavy_on_device,
                build_light_on_device,
            )

            if self._merged_heavy:
                # one scatter entry per (heavy term, segment) occurrence,
                # many-to-one onto merged rows
                h_starts = np.asarray(
                    [self.lex[s][t][0] for _r, s, t in heavy_entries],
                    np.int64,
                )
                h_dfs = np.asarray(
                    [self.lex[s][t][1] for _r, s, t in heavy_entries],
                    np.int64,
                )
                h_rows = np.asarray(
                    [r for r, _s, _t in heavy_entries], np.int64
                )
            else:
                h_starts = np.asarray([h[3] for h in heavy], np.int64)
                h_dfs = np.asarray([h[0] for h in heavy], np.int64)
                h_rows = None
            self.dense_rows, self.bucket_pos, heavy_max_occ = (
                build_heavy_on_device(
                    self.post_doc, self.post_score, h_starts, h_dfs,
                    rows=h_rows,
                    n_rows_pad=nd1_pad, n_slots=self.n_slots,
                    bf16=dcfg.dense_rows_bf16,
                    with_buckets=self._sparse and not self._heavy_direct,
                    three_d=self._sparse,
                )
            )
            self.dense_rows.block_until_ready()
            _tick("heavy_device_build")
            self.light_bucket_pos = None
            if self._sparse and light_host is not None:
                # host-built histogram table, one bulk upload (see the
                # light_host_build note above: ~10s vs 130+s device scatter)
                self.light_bucket_pos = put(light_host)
                self.light_bucket_pos.block_until_ready()
            elif self._sparse:
                l_starts = np.zeros(self.n_light, np.int64)
                l_dfs = np.zeros(self.n_light, np.int64)
                for seg_i, lmap in enumerate(self._light_row):
                    lex = self.lex[seg_i]
                    for t, row in lmap.items():
                        start, dfv, _ = lex[t]
                        l_starts[row] = start
                        l_dfs[row] = dfv
                self.light_bucket_pos, light_max_occ = (
                    build_light_on_device(
                        self.post_doc, l_starts, l_dfs,
                        n_rows_pad=self.n_light + 1,
                        n_slots=self.n_slots,
                        bucket_log2=self._lb_log2,
                    )
                )
            self._bs_depth = max(
                2,
                int(max(heavy_max_occ, light_max_occ, 1)).bit_length(),
            )
            _tick("light_device_build")
            self._build_row_topk(post_doc, post_score)
            _tick("row_topk")
            self._build_light_topk(post_doc_parts, post_score_parts)
            _tick("light_topk")
            self._build_merged_lex()
            _tick("merged_lex")
            _log_build_phases(_phases)
            return
        if dcfg.dense_rows_bf16:
            import ml_dtypes

            dense_host = dense_host.astype(ml_dtypes.bfloat16)
        if self._sparse:
            # sparse mode stores the table [rows, n_slots/128, 128]
            # (ops/heavy.heavy_fused3_xla)
            dense_host = dense_host.reshape(
                dense_host.shape[0], self.n_slots // 128, 128
            )
        self.dense_rows = put(dense_host)
        self.bucket_pos = put(bucket_host) if bucket_host is not None else None
        self.light_bucket_pos = (
            put(light_host) if light_host is not None else None
        )
        _tick("host_tables_upload")
        self._build_row_topk(post_doc, post_score)
        _tick("row_topk")
        self._build_light_topk(post_doc_parts, post_score_parts)
        _tick("light_topk")
        self._build_merged_lex()
        _tick("merged_lex")
        _log_build_phases(_phases)

    def _build_row_topk(self, post_doc_np=None, post_score_np=None) -> None:
        """Precompute exact canonical top-k for the df-head dense rows.

        A 1-term query on a heavy term is a pure function of its (merged)
        dense row, so search_batch answers it from this host table — zero
        device work and zero fast-path guard trips (df~N terms' 10th..K2th
        scores sit inside the bf16 selection error band, where the guard
        provably cannot pass; measured: every EVAL config-3 trip was the
        rank-1 Zipf term as a 1-term query). Rows are df-descending by
        build order, so the first `row_topk_rows` rows are the query-mass
        head; other single-term queries keep the kernel path."""
        dcfg = self.config.device
        self._row_topk = None
        if not (self._sparse and self._heavy_direct) or self.host_only:
            return
        n = min(self.n_dense, dcfg.row_topk_rows)
        k = min(dcfg.row_topk_k, self.n_slots)
        if n <= 0 or k <= 0:
            return
        if (
            post_doc_np is not None
            and os.environ.get("NEXTSEARCH_ROW_TOPK_BUILD", "host") == "host"
        ):
            self._row_topk = self._row_topk_host(
                n, k, post_doc_np, post_score_np
            )
            return
        from .device_build import build_row_topk_on_device

        vals, slots = build_row_topk_on_device(
            self.dense_rows, n, k=k, n_slots=self.n_slots
        )
        self._row_topk = (vals, slots)

    def _row_topk_host(self, n: int, k: int, post_doc, post_score):
        """Exact canonical top-k of the df-head rows from host postings.

        A dense row's nonzero values ARE the term's eager posting scores
        (merged across segments), so np.argpartition over each head
        term's posting lanes + one canonical sort of the k survivors
        reproduces the device row sort bit-for-bit at a fraction of the
        cost (device path measured 60-150s for 256 rows at 1M slots;
        this is ~1-2s of numpy). Device path kept behind
        NEXTSEARCH_ROW_TOPK_BUILD=device and the parity tests compare
        both against the oracle."""
        vals = np.zeros((n, k), np.float32)
        slots = np.full((n, k), 2**30, np.int32)
        # head terms by dense row id: row_id < n. Collect each row's
        # (start, df, segment) posting ranges from the per-segment lex.
        row_ranges: List[List[Tuple[int, int]]] = [[] for _ in range(n)]
        for lex in self.lex:
            for _t, (start, df, row_id) in lex.items():
                if 0 <= row_id < n and df > 0:
                    row_ranges[row_id].append((start, df))
        for row_id, ranges in enumerate(row_ranges):
            if not ranges:
                continue
            sc_parts = [post_score[s:s + d] for s, d in ranges]
            doc_parts = [post_doc[s:s + d] for s, d in ranges]
            sc = sc_parts[0] if len(sc_parts) == 1 else np.concatenate(sc_parts)
            doc = doc_parts[0] if len(doc_parts) == 1 else np.concatenate(doc_parts)
            if sc.shape[0] > k:
                part = np.argpartition(-sc, k - 1)[:k]
                sc = sc[part]
                doc = doc[part]
            order = np.lexsort((doc, -sc))
            m = order.shape[0]
            vals[row_id, :m] = sc[order]
            slots[row_id, :m] = doc[order]
        return vals, slots

    def _build_light_topk(self, post_doc_parts, post_score_parts) -> None:
        """Precompute exact canonical top-k per LIGHT (term, segment)
        posting range (host-side; the per-segment posting arrays are in
        hand at build either way).

        A 1-term light query is a pure function of its posting list(s),
        so search_batch answers it host-side like the heavy row-topk —
        and pin_shapes' workload probe skips eligible queries, shrinking
        the C/L2 budgets (light gather/sort volume IS wall time) by those
        queries' postings. Canonical (score desc, slot asc) tie order is
        exact via one uint64 key (score_bits << 24 | ~slot): positive f32
        bit patterns are order-isomorphic to uint32 and global slots fit
        24 bits (the packed result transport already requires that)."""
        self._light_topk = None
        dcfg = self.config.device
        kl = dcfg.light_topk_k
        if (
            not self._sparse
            or self.host_only
            or kl <= 0
            or self.n_light == 0
            or self.n_slots >= 1 << 24
        ):
            return
        kl = min(kl, self.n_slots)
        vals = np.zeros((self.n_light, kl), np.float32)
        slots = np.full((self.n_light, kl), 2**30, np.int32)
        for seg_i, lmap in enumerate(self._light_row):
            if not lmap:
                continue
            lex = self.lex[seg_i]
            pb = self._seg_pbase[seg_i]
            items = sorted(lmap.items(), key=lambda kv: kv[1])  # row asc
            rows_arr = np.asarray([r for _t, r in items], np.int64)
            starts = np.asarray(
                [lex[t][0] - pb for t, _r in items], np.int64
            )
            dfs = np.asarray([lex[t][1] for t, _r in items], np.int64)
            total = int(dfs.sum())
            if total == 0:
                continue
            cum = np.cumsum(dfs)
            rep = np.repeat(np.arange(len(items), dtype=np.int64), dfs)
            pos = (
                np.arange(total, dtype=np.int64)
                - np.repeat(cum - dfs, dfs)
                + starts[rep]
            )
            sc = np.ascontiguousarray(
                post_score_parts[seg_i][pos], dtype=np.float32
            )
            doc = post_doc_parts[seg_i][pos]  # global slots
            # One uint64 key + stable radix argsort instead of the old
            # 2-key lexsort (measured 42s -> ~5s on the 50M-lane 1M-doc
            # corpus): row in the high bits, INVERTED positive-f32 score
            # pattern below (ascending ~bits = score desc). Ties keep
            # stream order, and postings are doc-ascending within a row,
            # so canonical (score desc, slot asc) order is preserved
            # bit-for-bit — the same order the old slot-bearing key gave.
            key2 = (rep.astype(np.uint64) << np.uint64(32)) | (
                ~sc.view(np.uint32)
            ).astype(np.uint64)
            order = np.argsort(key2, kind="stable")  # row asc, key desc
            off = cum - dfs
            take = np.minimum(dfs, kl)
            sel_rows = np.repeat(np.arange(len(items)), take)
            within = np.arange(int(take.sum())) - np.repeat(
                np.cumsum(take) - take, take
            )
            src = order[off[sel_rows] + within]
            vals[rows_arr[sel_rows], within] = sc[src]
            slots[rows_arr[sel_rows], within] = doc[src]
        self._light_topk = (vals, slots)

    def _shortcut_single_heavy(self, queries, k: int):
        """Answer 1-term queries from precomputed tables, host-side.

        Heavy terms (merged dense row inside the row-topk head) read the
        row's canonical prefix; light terms merge their per-(term,
        segment) posting-prefix top-ks (exact: docs live in one segment,
        and a global top-k member is inside its own segment's top-k, so
        k <= light_topk_k keeps every candidate within the prefixes).

        Returns (queries, fills): shortcut queries are replaced with []
        (their plan slots empty out; the batch envelope is unchanged so
        no shape flap) and fills maps their ORIGINAL batch index to the
        finished QueryResult, applied after gather un-permutes. Exact:
        the reference accumulates score = w * eager_score once per doc
        for a 1-term query, and the stored prefixes are already canonical
        (score desc, slot asc); w != 1 re-sorts after the multiply and an
        INCOMPLETE prefix must keep its k-th value strictly above the
        stored tail (else a doc outside could tie in — fall back to the
        kernel). Duplicate-term queries accumulate twice and never
        shortcut.

        w == 1 results (the entire organic 1-term stream: expansion
        produces multi-term queries, so off-1 weights never reach here)
        are memoized per (term, k) — Zipf query streams repeat head
        terms constantly, and the memo turns the numpy merge into one
        dict probe per query. QueryResults are shared across hits; they
        are read-only downstream.
        """
        lt = getattr(self, "_light_topk", None)
        if self._row_topk is None and lt is None:
            return queries, None
        memo = self._shortcut_memo
        fills = {}
        out = None
        for qi, terms in enumerate(queries):
            if len(terms) != 1:
                continue
            t, w = terms[0]
            w32 = np.float32(w)
            if not (w32 > 0) or not np.isfinite(w32):
                continue
            if w32 == np.float32(1.0):
                key = (t, k)
                res = memo.get(key, False)
                if res is False:
                    res = self._shortcut_compute(t, w32, k, lt)
                    if len(memo) >= 200_000:
                        memo.clear()
                    memo[key] = res
            else:
                res = self._shortcut_compute(t, w32, k, lt)
            if res is None:
                continue
            if out is None:
                out = list(queries)
            fills[qi] = res
            out[qi] = []
        return (out, fills) if fills else (queries, None)

    def _shortcut_compute(self, t, w32, k, lt):
        """One term's host-side 1-term answer, or None for the kernel
        path (see _shortcut_single_heavy for the exactness rules)."""
        oc = self._lex_slices.get(t)
        if oc is None:
            return None
        ent_all = self._lex_table[oc[0] : oc[0] + oc[1]]
        if (
            oc[1] == 1
            and ent_all[0, 2] >= 0
            and self._row_topk is not None
        ):
            ent = ent_all[0]
            vals_t, slots_t = self._row_topk
            kp = vals_t.shape[1]
            row = int(ent[2])
            if k > kp or row >= vals_t.shape[0]:
                return None
            vals = vals_t[row]
            slots = slots_t[row]
            if w32 != np.float32(1.0):
                sv = w32 * vals
                if not sv[min(k, kp) - 1] > sv[-1]:
                    return None  # multiply collapsed the prefix boundary
                order = np.lexsort((slots, -sv))
                sv = sv[order]
                slots = slots[order]
            else:
                sv = vals
            found = int(ent[1])
        elif lt is not None and (ent_all[:, 2] < 0).all():
            vals_l, slots_l = lt
            kl = vals_l.shape[1]
            if k > kl or (ent_all[:, 5] >= self.n_light).any():
                return None
            sv_all = []
            gs_all = []
            found = 0
            for ent in ent_all:
                row = int(ent[5])
                df = int(ent[1])
                sv1 = (
                    vals_l[row]
                    if w32 == np.float32(1.0)
                    else w32 * vals_l[row]
                )
                if (
                    df > kl
                    and w32 != np.float32(1.0)
                    and not sv1[min(k, kl) - 1] > sv1[-1]
                ):
                    return None  # collapsed incomplete-prefix boundary
                sv_all.append(sv1)
                gs_all.append(slots_l[row])
                found += df
            if len(sv_all) == 1 and w32 == np.float32(1.0):
                sv, slots = sv_all[0], gs_all[0]
            else:
                sv = np.concatenate(sv_all)
                slots = np.concatenate(gs_all)
                order = np.lexsort((slots, -sv))
                sv = sv[order]
                slots = slots[order]
        else:
            return None
        live = sv > 0
        return QueryResult(
            scores=sv[live][:k].astype(np.float32),
            doc_slots=slots[live][:k].astype(np.int32),
            found=found,
        )

    def _build_merged_lex(self) -> None:
        """Merge per-segment lexicons into one packed table for planning.

        _lex_slices: term -> (offset, count) into _lex_table, whose rows are
        (global posting start, df, dense_row_id, idf_bits, avgdl_bits,
        light_row_id) — one row per (term, segment) occurrence, segments
        ascending (preserving the canonical term-major/segment-ascending
        slot order). idf/avgdl are f32 bit patterns (idf via the platform
        logf, utils/floatops.py) so sparse-mode planning never recomputes
        them; light_row_id indexes light_bucket_pos (n_light for heavy
        slots / non-sparse mode). Querying costs ONE dict probe per
        (query, term) plus NumPy gathers, instead of a Python loop over
        every segment (VERDICT r1 item 7).
        """
        from ..utils.floatops import logf_exact

        light_maps = getattr(self, "_light_row", None)
        merged = getattr(self, "_merged_heavy", False)
        occ: Dict[str, List[Tuple[int, int, int, int, int, int]]] = {}
        for seg_i, lex in enumerate(self.lex):
            seg = self.segments[seg_i]
            avgdl_bits = int(
                np.float32(seg.avgdl).view(np.uint32)
            )
            lmap = light_maps[seg_i] if light_maps else {}
            # vectorized idf for this segment's lexicon, in lex order
            items = [(t, v) for t, v in lex.items() if v[1] > 0]
            if items:
                dfs = np.asarray([v[1] for _t, v in items], np.uint32)
                num = (np.uint32(seg.N) - dfs).astype(np.float32) + np.float32(0.5)
                den = dfs.astype(np.float32) + np.float32(0.5)
                idf = logf_exact(num / den + np.float32(1.0))
                idf_bits = idf.view(np.uint32)
                nl = getattr(self, "n_light", 0)
                for (t, v), ib in zip(items, idf_bits):
                    if merged and v[2] >= 0:
                        # merged dense row: ONE planning slot per heavy
                        # term across all segments (df = global df; the
                        # posting start is meaningless and unused — the
                        # direct rescore reads scores off the row)
                        if t not in occ:
                            occ[t] = [
                                (0, self._gdf[t], v[2], int(ib),
                                 avgdl_bits, nl)
                            ]
                        continue
                    occ.setdefault(t, []).append(
                        (v[0], v[1], v[2], int(ib), avgdl_bits,
                         lmap.get(t, nl))
                    )
        n_rows = sum(len(v) for v in occ.values())
        table = np.zeros((max(n_rows, 1), 6), np.int64)
        slices: Dict[str, Tuple[int, int]] = {}
        pos = 0
        for t, vs in occ.items():
            slices[t] = (pos, len(vs))
            for v in vs:
                table[pos] = v
                pos += 1
        self._lex_table = table
        self._lex_slices = slices

    # ---------------- common index interface ----------------
    # (shared with parallel.sharded.ShardedIndex so Engine/HybridIndex code
    #  works against either)

    def iter_lexicons(self):
        """Yield every per-segment lexicon dict (term -> (start, df, dense))."""
        return iter(self.lex)

    @property
    def slot_capacity(self) -> int:
        """Size of the global doc-slot space (doc_slots index into this)."""
        return self.n_slots

    def segment_slot_bases(self) -> List[int]:
        """Global doc-slot base per segment, aligned with self.segments."""
        return list(self.doc_bases)

    # ---------------- shape pinning ----------------

    def probe_workload(
        self, batches: Sequence[Sequence[Sequence[WeightedTerm]]],
        shortcut_k: int = 10,
    ) -> Dict[str, int]:
        """Max static-shape drivers over a sample workload (host-only).

        Returns {"T": max term slots per query, "Q": max batch size,
        "C": max live posting chunks per batch, "U": max unique dense
        rows per batch, "W": max summed light dfs of one query (the
        selection-window driver), "L": max live light (query, slot)
        pairs per batch (the v4 compact-rescore block), "HP": max live
        heavy (query, slot) pairs per batch (the v5 compact heavy-value
        gather)} — the inputs pin_shapes() freezes. Costs one lexicon probe per (query, term);
        no device work.

        The probe applies the 1-term shortcut (row/light top-k tables) at
        `shortcut_k` first, exactly as serving does, so the pinned C/L2
        budgets exclude host-answered queries' postings. A serving
        request with k above the precomputed table width falls back to
        the kernel and takes a bounded, logged escape shape.
        """
        block = self.config.device.posting_block
        table = self._lex_table
        t = q = c = u = w = li = hp = 1
        for b in batches:
            q = max(q, len(b))
            b, _f = self._shortcut_single_heavy(b, shortcut_k)
            q_rows, _q_ws = _probe_queries(self._lex_slices, b)
            rows_all = [r for r in q_rows if r.shape[0]]
            if not rows_all:
                continue
            t = max(t, max(r.shape[0] for r in rows_all))
            for r in rows_all:
                ent_q = table[r]
                w = max(w, int(ent_q[ent_q[:, 2] < 0, 1].sum()))
            ent = table[np.concatenate(rows_all)]
            dense = ent[:, 2]
            light_df = ent[dense < 0, 1]
            c = max(c, int(np.sum((light_df + block - 1) // block)))
            u = max(u, int(np.unique(dense[dense >= 0]).shape[0]))
            li = max(li, int((dense < 0).sum()))
            hp = max(hp, int((dense >= 0).sum()))
        return {"T": t, "Q": q, "C": c, "U": u, "W": w, "L": li, "HP": hp}

    def pin_shapes(
        self,
        probe_batches=None,
        *,
        T: Optional[int] = None,
        Q: Optional[int] = None,
        C: Optional[int] = None,
        U: Optional[int] = None,
        W: Optional[int] = None,
        L: Optional[int] = None,
        HP: Optional[int] = None,
        c_pad: int = 128,
        u_pad: int = 16,
        scope_q: bool = False,
    ) -> Dict[str, int]:
        """Freeze the batch-varying static kernel shapes for serving.

        Any batch within the pinned envelope then compiles to ONE kernel
        shape; mid-serving recompiles (bucket flapping — the failure class
        CLAUDE.md forbids) become impossible for covered workloads, and
        overflow escapes are bounded (multiples of the pin) and logged.

        Sizes come from `probe_batches` (a sample workload; see
        probe_workload) and/or explicit keyword pins, which win. Returns
        the active pin dict. Replaces the ad-hoc probe-then-pin dances
        bench.py / benchmarks/eval_configs.py used to hand-roll.

        scope_q=True pins {C, U, W} for the probe's Q ENVELOPE only (the
        Q bucket those batches compile under), leaving other batch sizes
        on their own scopes/ladders. A server whose batching queue emits
        mixed sizes calls this once per expected size (see Engine.warmup)
        so a 1-query request neither pads to the max-batch C/U/W envelope
        nor flaps the big batches' shapes. T is NOT scoped: a probe that
        under-represents term counts (e.g. before semantic expansion)
        would seed more escape shapes than the bounded T ladder. Scoped
        pins win over global ones; requires probe_batches.
        """
        if scope_q:
            if probe_batches is None:
                raise ValueError("scope_q=True requires probe_batches")
            m = self.probe_workload(probe_batches)
            qb = _pick_shape(m["Q"], self.Q_BUCKETS, self._pins.get("Q"))
            scope = self._qpins.setdefault(qb, {})
            for k, v in (
                ("C", C or _round_up(m["C"], c_pad)),
                ("U", U or _round_up(m["U"] + 1, u_pad)),
                ("W", W or _bucket(m["W"], self.W_BUCKETS)),
                ("L", L or _bucket(m["L"], self.L_BUCKETS)),
                ("HP", HP or _bucket(m["HP"], self.HP_BUCKETS)),
            ):
                scope[k] = int(v)
            return {qb: dict(scope)}
        if probe_batches is not None:
            m = self.probe_workload(probe_batches)
            T = T or _bucket(m["T"], self.T_BUCKETS)
            Q = Q or _bucket(m["Q"], self.Q_BUCKETS)
            C = C or _round_up(m["C"], c_pad)
            U = U or _round_up(m["U"] + 1, u_pad)
            W = W or _bucket(m["W"], self.W_BUCKETS)
            L = L or _bucket(m["L"], self.L_BUCKETS)
            HP = HP or _bucket(m["HP"], self.HP_BUCKETS)
        for k, v in (
            ("T", T), ("Q", Q), ("C", C), ("U", U), ("W", W), ("L", L),
            ("HP", HP),
        ):
            if v:
                self._pins[k] = int(v)
        return dict(self._pins)

    def _pin(self, key: str, qb: Optional[int] = None) -> Optional[int]:
        """Effective pin for `key`: the Q-scoped pin for this batch's Q
        envelope (pin_shapes(scope_q=True)) wins over the global pin.

        A Q envelope with NO scoped pin borrows the nearest LARGER warmed
        envelope's pin (else the largest). Unpinned budgets re-derive
        C/L2/H2/W from each batch's own workload, so successive batches
        flap static shapes and EVERY batch pays a fresh XLA compile when
        the dispatcher emits a batch size warmup had not pinned. Borrowed
        pins over-pad smaller batches (bounded
        waste) but guarantee one compiled shape per Q bucket."""
        if qb is not None:
            v = self._qpins.get(qb, {}).get(key)
            if v:
                return v
            # Borrow ONLY from larger envelopes: a smaller envelope's pin
            # would under-budget this batch and flap escape shapes instead.
            # (Warmup always pins the max_batch envelope, so every serving
            # batch has a larger-or-equal warmed scope to borrow.)
            larger = [q for q in self._qpins if q > qb]
            if larger:
                v = self._qpins[min(larger)].get(key)
                if v:
                    return v
        return self._pins.get(key)

    # ---------------- query planning ----------------

    def plan(
        self, queries: Sequence[Sequence[WeightedTerm]]
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Pack weighted term lists into padded (starts, dfs, weights).

        Slot order is term-major, segment ascending; inactive slots carry
        df=0/weight=0 and are no-ops in the kernel.
        """
        starts, dfs, weights, _l, _u, _m = self.plan_full(queries)
        return starts, dfs, weights

    def plan_full(self, queries: Sequence[Sequence[WeightedTerm]]):
        """plan() + hybrid split: light dfs and the unique-heavy-row mix.

        Vectorized: one _lex_slices probe per (query, term), then NumPy
        gathers from the merged _lex_table fill the padded plan arrays.
        """
        table = self._lex_table
        q_rows, q_ws = _probe_queries(self._lex_slices, queries)
        t_max = max((r.shape[0] for r in q_rows), default=0)

        Qb = _pick_shape(
            len(queries), self.Q_BUCKETS, self._pins.get("Q"), "Q"
        )
        T = _pick_shape(t_max, self.T_BUCKETS, self._pin("T", Qb), "T")

        starts = np.zeros((Qb, T), np.int32)
        dfs = np.zeros((Qb, T), np.int32)
        weights = np.zeros((Qb, T), np.float32)
        light_dfs = np.zeros((Qb, T), np.int32)
        heavy_q: List[np.ndarray] = []
        heavy_id: List[np.ndarray] = []
        heavy_w: List[np.ndarray] = []
        for qi, (rows, ws) in enumerate(zip(q_rows, q_ws)):
            n = min(rows.shape[0], T)
            if n == 0:
                continue
            rows = rows[:n]
            ws = ws[:n]
            ent = table[rows]  # [n, 3]
            starts[qi, :n] = ent[:, 0]
            dfs[qi, :n] = ent[:, 1]
            weights[qi, :n] = ws
            dense = ent[:, 2]
            light = dense < 0
            light_dfs[qi, :n] = np.where(light, ent[:, 1], 0)
            if not light.all():
                hm = ~light
                heavy_q.append(np.full(int(hm.sum()), qi, np.int64))
                heavy_id.append(dense[hm])
                heavy_w.append(ws[hm])

        if heavy_id:
            h_ids = np.concatenate(heavy_id)
            uniq_ids, inv = np.unique(h_ids, return_inverse=True)
            n_uniq = uniq_ids.shape[0]
        else:
            uniq_ids = _EMPTY_I64
            inv = _EMPTY_I64
            n_uniq = 0
        hb = self.config.device.heavy_buckets
        U = _pick_shape(n_uniq, hb, self._pin("U", Qb), "U")
        unique_heavy = np.full(U, self.n_dense, np.int32)  # pad -> zero row
        heavy_mix = np.zeros((Qb, U), np.float32)
        if n_uniq:
            unique_heavy[:n_uniq] = uniq_ids
            np.add.at(
                heavy_mix,
                (np.concatenate(heavy_q), inv),
                np.concatenate(heavy_w),
            )
        return starts, dfs, weights, light_dfs, unique_heavy, heavy_mix

    def plan_sparse(
        self,
        queries: Sequence[Sequence[WeightedTerm]],
        q_override: Optional[int] = None,
        t_override: Optional[int] = None,
    ):
        """Sparse-mode plan: packed int/f32 plan blocks for
        ops/bm25_sparse.bm25_search_sparse_packed.

        q_override/t_override force the Qb/T envelope (multi-launch groups
        must stack into one [G, 7, Qb, T] block; _pick_shape treats them
        like pins, so an overflowing group still escapes loudly).

        Returns (plan int32 [7, Qb, T], U) — one device upload:
          rows: starts / light_dfs (0 for heavy: excluded from chunk
                expansion) / slot_dense (n_dense = light) / slot_light
                (light_bucket_pos row id; n_light = heavy/padding) /
                slot_compact (compact unique-row id; U = light/padding) /
                weight f32 bit patterns (pure bitcast; weights are normal
                floats, never denormal) / the U unique dense row ids this
                batch touches (row-major, U <= Qb*T by construction;
                unused entries = n_dense -> zero row)
          U:    static compact-table size (bucketed via heavy_buckets)
        """
        table = self._lex_table
        rows_all, ws_all, q_lens = _probe_queries_flat(
            self._lex_slices, queries
        )
        t_max = int(q_lens.max()) if q_lens.size else 0

        Qb = _pick_shape(
            len(queries), self.Q_BUCKETS,
            q_override or self._pins.get("Q"), "Q",
        )
        T = _pick_shape(
            t_max, self.T_BUCKETS, t_override or self._pin("T", Qb), "T"
        )
        plan_ints = np.zeros((7, Qb, T), np.int32)
        plan_ints[2] += np.int32(self.n_dense)  # default: light/padding
        plan_ints[3] += np.int32(self.n_light)  # default: sentinel row
        weights = np.zeros((Qb, T), np.float32)
        # Flat vectorized fill: a per-query Python loop here is serial
        # host time that caps serving QPS no matter how fast the device is.
        ti_all = _ranges(q_lens)
        keep = ti_all < T  # clip each query's rows to the T envelope
        total = int(keep.sum())
        if total:
            rows_flat = rows_all[keep]
            ws_flat = ws_all[keep]
            qi_flat = np.repeat(
                np.arange(len(queries), dtype=np.int64), q_lens
            )[keep]
            ti_flat = ti_all[keep]
            ent = table[rows_flat]  # [total, 6]
            dense = ent[:, 2]
            light = dense < 0
            plan_ints[0, qi_flat, ti_flat] = ent[:, 0]
            plan_ints[1, qi_flat, ti_flat] = np.where(light, ent[:, 1], 0)
            plan_ints[2, qi_flat, ti_flat] = np.where(
                light, self.n_dense, dense
            )
            plan_ints[3, qi_flat, ti_flat] = np.where(
                light, ent[:, 5], self.n_light
            )
            weights[qi_flat, ti_flat] = ws_flat
            hm = ~light
            ids = dense[hm]
        else:
            ids = _EMPTY_I64

        # Compact heavy-row table for this batch (kernel gathers these rows
        # and runs the mix over compact ids instead of the full table).
        if ids.size:
            uniq, inv = np.unique(ids, return_inverse=True)
            n_uniq = uniq.shape[0]
        else:
            uniq = _EMPTY_I64
            inv = _EMPTY_I64
            n_uniq = 0
        hb = self.config.device.heavy_buckets
        U = _pick_shape(n_uniq, hb, self._pin("U", Qb), "U")
        plan_ints[4] = np.int32(U)  # default: light/padding -> zero row
        if n_uniq:
            plan_ints[4, qi_flat[hm], ti_flat[hm]] = inv
        plan_ints[5] = weights.view(np.int32)
        idbuf = np.full(Qb * T, self.n_dense, np.int32)
        idbuf[:n_uniq] = uniq
        plan_ints[6] = idbuf.reshape(Qb, T)
        return plan_ints, U

    # ---------------- execution ----------------

    def _plan_groups(self, queries, g: int):
        """Plan G block-diagonal sub-batches with ONE [G, 7, Qb, T] shape.

        Qb is forced to the group size; T starts at the pin (or group 1's
        envelope) and the loop restarts if a later group overflows it —
        rare, and the escape is already logged by _pick_shape. U is the
        max over groups: a plan built under a smaller U stays valid in a
        larger-U kernel (its padding slots point at zero dense rows).
        """
        n = len(queries)
        gn = -(-n // g)
        t_ov = self._pin("T", g)
        while True:
            plans = []
            us = []
            for gi in range(gn):
                p, u = self.plan_sparse(
                    queries[gi * g : (gi + 1) * g],
                    q_override=g, t_override=t_ov,
                )
                if t_ov is None:
                    t_ov = p.shape[2]
                elif p.shape[2] != t_ov:
                    t_ov = max(t_ov, p.shape[2])
                    break
                plans.append(p)
                us.append(u)
            else:
                return np.stack(plans), max(us)

    def _search_sparse_async(self, queries, k: int, shortcut: bool = True):
        """Launch the sparse-light kernel (mode='sparse')."""
        import jax

        from ..ops.bm25_sparse import (
            bm25_search_sparse_packed,
            bm25_search_sparse_packed_multi,
            bm25_search_sparse_unified,
        )

        nq = len(queries)
        K = _bucket(max(k, 1), self.K_BUCKETS)
        K = min(K, self.n_slots)

        # 1-term head-heavy queries: answered host-side from the
        # precomputed row top-k (exact, canonical, zero guard trips);
        # their batch slots plan as empty queries.
        queries, fills = (
            self._shortcut_single_heavy(queries, k)
            if shortcut
            else (queries, None)
        )
        # Known guard-trippers answer from the rescue memo with zero
        # device work (their plan slots empty out, like the shortcuts).
        if shortcut and self._rescue_memo:
            K_memo = _bucket(max(k, 1), self.K_BUCKETS)
            K_memo = min(K_memo, self.n_slots)
            out_q = None
            for qi, terms in enumerate(queries):
                if fills is not None and qi in fills:
                    continue
                res = self._rescue_memo.get((tuple(terms), K_memo))
                if res is None:
                    continue
                if fills is None:
                    fills = {}
                if out_q is None:
                    out_q = list(queries)
                fills[qi] = QueryResult(
                    scores=res.scores[:k], doc_slots=res.doc_slots[:k],
                    found=res.found,
                )
                out_q[qi] = []
            if out_q is not None:
                queries = out_q
        if fills is not None and len(fills) == nq:
            # Every query in the batch was answered host-side — skip the
            # device launch entirely (a single-term stream over a head-
            # heavy vocabulary, e.g. BASELINE config 1, is ALL shortcut;
            # an empty-plan launch would cost a host round trip for zero
            # device work).
            return ("fills", nq, k, fills)

        g = self._pins.get("Q") or self.config.device.launch_group
        # Optional (NEXTSEARCH_SORT_QUERIES=1): order queries by light-
        # window size (summed light dfs) so big windows cluster. Results
        # are un-permuted on the host at gather time, and the stable order
        # keeps everything deterministic. With multi-launch groups the sorted order is
        # DEALT round-robin across the groups: a plain global sort would
        # concentrate the big windows (and their postings) into the last
        # group, whose inflated C/L2 would then size the ONE kernel shape
        # all groups share. Dealing keeps each group internally sorted (a
        # stride of a sorted list is sorted) and window mass balanced.
        perm = None
        forced = os.environ.get("NEXTSEARCH_SORT_QUERIES") == "1"
        if forced and nq > 1:
            wins = self._query_windows(queries)
            # below ~1 block per query the kernel is already minimal
            if wins.size:
                order = np.argsort(wins, kind="stable")
                if g and nq > g:
                    perm = _deal_sorted(order, g)
                else:
                    perm = order
                queries = [queries[i] for i in perm]
        fast = (
            self.config.device.fast_heavy
            and self._heavy_direct
            and os.environ.get("NEXTSEARCH_FAST_HEAVY", "1") == "1"
        )
        eps = self.config.device.fast_heavy_eps
        if g and nq > g:
            plans, U = self._plan_groups(queries, g)
            block = self.config.device.posting_block
            C = max(
                self._chunk_budget(plans[gi, 1], block)
                for gi in range(plans.shape[0])
            )
            L2 = max(
                self._light_budget(plans[gi])
                for gi in range(plans.shape[0])
            )
            H2 = max(
                self._heavy_budget(plans[gi])
                for gi in range(plans.shape[0])
            )
            K2 = min(
                max(2 * K, self.config.device.rescore_margin), self.n_slots
            )
            use_compact = (
                os.environ.get("NEXTSEARCH_COMPACT_HEAVY", "1") == "1"
            )

            def launch_multi(fh: bool):
                # The exact relaunch (fh=False under fast mode)
                # runs FULL-TABLE: the compact path's f32 gather table is
                # O(U * n_slots) HBM that big envelopes cannot afford
                # next to the dense rows (EVAL config 3 failed to
                # compile), and heavy_fused3 reads the stored 3D layout
                # with no extra buffer at all.
                uc = use_compact and (fh or not fast)
                out = bm25_search_sparse_packed_multi(
                    self.post_doc, self.post_score, self.dense_rows,
                    self.bucket_pos, self.light_bucket_pos, plans,
                    n_slots=self.n_slots, K=K, K2=K2, C=C, block=block,
                    bs_steps=self._bs_depth, nd=self.n_dense,
                    nl=self.n_light,
                    U=U if uc else 0,
                    use_compact=uc,
                    heavy_direct=self._heavy_direct,
                    fast_heavy=fh, guard_eps=eps,
                    h_bf16=os.environ.get("NEXTSEARCH_H_BF16", "0") == "1",
                    lb_log2=self._lb_log2, L2=L2, H2=H2,
                )
                out.copy_to_host_async()
                return out

            if fast:
                return (
                    "packedg", nq, k, K, launch_multi(True),
                    lambda: launch_multi(False), perm, queries, fills,
                )
            return ("packed", nq, k, K, launch_multi(False), perm, fills)

        plan, U = self.plan_sparse(queries)
        block = self.config.device.posting_block
        C = self._chunk_budget(plan[1], block)
        L2 = self._light_budget(plan)
        H2 = self._heavy_budget(plan)
        K2 = min(max(2 * K, self.config.device.rescore_margin), self.n_slots)
        from ..ops.bm25_sparse import LIGHT_BUCKET_LOG2 as _LB_DEFAULT

        unified = (
            self.config.device.unified
            and os.environ.get("NEXTSEARCH_UNIFIED", "1") == "1"
            # the unified kernel hard-codes the default light bucket
            # granularity and always runs over the compact gathered
            # table; adaptively-coarsened or compact-off indexes take
            # the packed path
            and self._lb_log2 == _LB_DEFAULT
            and os.environ.get("NEXTSEARCH_COMPACT_HEAVY", "1") == "1"
        )
        use_compact = (
            os.environ.get("NEXTSEARCH_COMPACT_HEAVY", "1") == "1"
        )
        if not use_compact:
            # The full-table kernel never reads the unique-id row; freeze
            # U so a batch with more distinct heavy rows cannot trigger a
            # recompile mid-serving.
            U = 0
        # Depth = measured max bucket occupancy of the light bucket-
        # position table (v4/v5; + heavy when bf16 rows use v2).
        def launch_single(fh: bool):
            # exact relaunch runs full-table — see launch_multi
            uc = use_compact and (fh or not fast)
            out = bm25_search_sparse_packed(
                self.post_doc, self.post_score, self.dense_rows,
                self.bucket_pos, self.light_bucket_pos, plan,
                n_slots=self.n_slots, K=K, K2=K2, C=C, block=block,
                bs_steps=self._bs_depth, nd=self.n_dense, nl=self.n_light,
                U=U if uc else 0,
                use_compact=uc,
                heavy_direct=self._heavy_direct,
                fast_heavy=fh, guard_eps=eps,
                h_bf16=os.environ.get("NEXTSEARCH_H_BF16", "0") == "1",
                lb_log2=self._lb_log2, L2=L2, H2=H2,
            )
            out.copy_to_host_async()
            return out

        if unified:
            # Unified-totals kernel: light entries fold INTO the heavy
            # matmul output, replacing the split path's H-gather and
            # light selection sort. The fast mode is guarded like the packed
            # fast path; trips relaunch the EXACT wide PACKED kernel
            # (full f32 selection keys, two-pool union) — the most
            # conservative exact path.
            def launch_unified():
                out = bm25_search_sparse_unified(
                    self.post_doc, self.post_score, self.dense_rows,
                    self.bucket_pos, self.light_bucket_pos, plan,
                    n_slots=self.n_slots, K=K, K2=K2, C=C, block=block,
                    bs_steps=self._bs_depth, nd=self.n_dense,
                    nl=self.n_light,
                    U=U,
                    heavy_direct=self._heavy_direct,
                    fast_heavy=fast, guard_eps=eps, L2=L2,
                )
                out.copy_to_host_async()
                return out

            if fast:
                return (
                    "packedg", nq, k, K, launch_unified(),
                    lambda: launch_single(False), perm, queries, fills,
                )
            return ("packed", nq, k, K, launch_unified(), perm, fills)

        if fast:
            return (
                "packedg", nq, k, K, launch_single(True),
                lambda: launch_single(False), perm, queries, fills,
            )
        return ("packed", nq, k, K, launch_single(False), perm, fills)

    def search_batch_async(self, queries: Sequence[Sequence[WeightedTerm]], k: int,
                           shortcut: bool = True):
        """Launch one batched BM25 top-k kernel; returns an opaque handle.

        Pair with search_batch_gather(); keeping several launches in flight
        hides the host<->device round-trip latency (serving pipeline).
        shortcut=False disables the host-side 1-term/rescue-memo answers —
        the hybrid rerank chains on the packed DEVICE array and needs every
        query's candidates in it (models/hybrid.py).
        """
        from ..ops.bm25 import bm25_topk_exact, bm25_topk_fast, bm25_topk_fused

        nq = len(queries)
        if nq == 0 or self.n_docs == 0:
            return ("empty", nq)
        if self.config.device.mode == "sparse":
            return self._search_sparse_async(queries, k, shortcut=shortcut)

        K = _bucket(max(k, 1), self.K_BUCKETS)
        K = min(K, self.n_slots)
        starts, dfs, weights, light_dfs, unique_heavy, heavy_mix = (
            self.plan_full(queries)
        )
        block = self.config.device.posting_block
        mode = self.config.device.mode

        if mode == "exact":
            vals, idx, found = bm25_topk_exact(
                self.post_doc, self.post_score, starts, dfs, weights,
                n_slots=self.n_slots, K=K, block=block,
            )
        elif mode == "fast":
            chunk_start, chunk_len, chunk_q, chunk_w = self._chunk_plan(
                starts, dfs, weights, block
            )
            vals, idx, found = bm25_topk_fast(
                self.post_doc, self.post_score,
                chunk_start, chunk_len, chunk_q, chunk_w,
                n_slots=self.n_slots, K=K, Q=starts.shape[0], block=block,
            )
        else:  # fused (default): transfer-minimal packed launch
            from ..ops.bm25 import bm25_search_packed

            K2 = min(max(2 * K, self.config.device.rescore_margin), self.n_slots)
            C = self._chunk_budget(light_dfs, block)
            Qb, T = starts.shape
            U = unique_heavy.shape[0]
            plan_ints = np.stack([starts, dfs, light_dfs])
            plan_f32 = np.zeros((Qb + 1, T + U), np.float32)
            plan_f32[:Qb, :T] = weights
            plan_f32[:Qb, T:] = heavy_mix
            # ids as exact f32 values (< 2^24), never bit-packed: denormal
            # bit patterns may be flushed to zero by device f32 ops
            plan_f32[Qb, T:] = unique_heavy.astype(np.float32)
            bs_steps = max(2, self.n_slots.bit_length() + 1)
            out = bm25_search_packed(
                self.post_doc, self.post_score, self.dense_rows,
                plan_ints, plan_f32,
                n_slots=self.n_slots, K=K, K2=K2, C=C, block=block,
                bs_steps=bs_steps,
                scores_bf16=self.config.device.scores_bf16,
            )
            out.copy_to_host_async()
            return ("packed", nq, k, K, out)
        for arr in (vals, idx, found):
            arr.copy_to_host_async()
        return ("pending", nq, k, K, vals, idx, found)

    def search_batch_gather(self, handle) -> List[QueryResult]:
        """Fetch + unpack the results of a search_batch_async launch."""
        import jax

        if handle[0] == "empty":
            nq = handle[1]
            return [
                QueryResult(np.empty(0, np.float32), np.empty(0, np.int32), 0)
            ] * nq
        if handle[0] == "fills":
            # whole batch answered host-side by the 1-term shortcut
            _tag, nq, _k, fills = handle
            return [fills[qi] for qi in range(nq)]
        fills = None
        if handle[0] in ("packed", "packedg"):
            perm = handle[6] if handle[0] == "packedg" and len(handle) > 6 \
                else handle[5] if handle[0] == "packed" and len(handle) > 5 \
                else None
            fills = handle[8] if handle[0] == "packedg" and len(handle) > 8 \
                else handle[6] if handle[0] == "packed" and len(handle) > 6 \
                else None
            if handle[0] == "packedg":
                _tag, nq, k, K, dev_out, relaunch = handle[:6]
                queries = handle[7] if len(handle) > 7 else None
                out = np.asarray(jax.device_get(dev_out))
                tripped = np.flatnonzero(out[:nq, 2 * K + 1] < 0.5)
                if tripped.size:
                    # Guard failed for >=1 query: the DEFAULT-precision
                    # merged-pool selection could not prove the top-K.
                    # Results must stay bit-exact either way:
                    #  - few trips: rescore those QUERIES on the host with
                    #    the vectorized exact oracle — cheaper than a
                    #    whole-batch relaunch, and the only exact path at
                    #    envelopes where the wide kernel's f32 compact +
                    #    light tables exceed device memory.
                    #  - many trips: one wide exact relaunch.
                    from ..utils.logging import log

                    cap = int(
                        os.environ.get("NEXTSEARCH_TRIP_RESCUE", "8")
                    )
                    if queries is not None and tripped.size <= cap:
                        t0 = time.perf_counter()
                        out = np.array(out)  # device_get view is read-only
                        for j in tripped:
                            self._host_rescue_row(out, int(j), queries,
                                                  K)
                        dt = (time.perf_counter() - t0) * 1000.0
                        self.rescue_ms += dt
                        self.rescue_trips += int(tripped.size)
                        log(
                            "sparse",
                            f"fast-heavy guard tripped ({tripped.size}/"
                            f"{nq} queries); host-oracle rescue "
                            f"{dt:.1f}ms",
                        )
                        if os.environ.get("NEXTSEARCH_TRIP_LOG") == "1":
                            for j in tripped:
                                terms = queries[int(j)]
                                dfs = [
                                    int(
                                        sum(
                                            lex.get(t, (0, 0, -1))[1]
                                            for lex in self.lex
                                        )
                                    )
                                    for t, _w in terms
                                ]
                                log(
                                    "trip",
                                    f"q={[t for t, _ in terms]} dfs={dfs}",
                                )
                    else:
                        log(
                            "sparse",
                            f"fast-heavy guard tripped "
                            f"({tripped.size}/{nq} queries); relaunching "
                            f"exact-precision kernel",
                        )
                        out = np.asarray(jax.device_get(relaunch()))
            else:
                _tag, nq, k, K, out = handle[:5]
                out = np.asarray(jax.device_get(out))
            vals = out[:, :K]
            idx = out[:, K : 2 * K].astype(np.int32)
            found = out[:, 2 * K].astype(np.int32)
        else:
            perm = None
            _tag, nq, k, K, vals, idx, found = handle
            # One batched device->host fetch instead of one round trip per
            # array.
            vals, idx, found = jax.device_get((vals, idx, found))
        out: List[QueryResult] = []
        for qi in range(nq):
            keep = vals[qi] > 0.0
            keep[min(k, K):] = False
            out.append(
                QueryResult(
                    scores=vals[qi][keep][:k],
                    doc_slots=idx[qi][keep][:k],
                    found=int(found[qi]),
                )
            )
        if perm is not None:
            # undo the window-size query ordering (row j held the query
            # originally at index perm[j])
            res = [out[0]] * nq
            for j in range(nq):
                res[perm[j]] = out[j]
            out = res
        if fills:
            # 1-term head-heavy queries answered host-side (fills are
            # keyed by ORIGINAL batch index — applied after un-permute)
            for qi, qr in fills.items():
                out[qi] = qr
        return out

    def search_batch(
        self, queries: Sequence[Sequence[WeightedTerm]], k: int
    ) -> List[QueryResult]:
        """Run one batched BM25 top-k kernel for all queries (blocking)."""
        return self.search_batch_gather(self.search_batch_async(queries, k))

    def _light_budget(self, plan_ints) -> int:
        """Static live light-pair count L2 for the v4 compact rescore.

        plan_ints is one sparse plan [7, Qb, T] (or one group of the
        multi-launch block). Pairs are (query, slot) with a live light
        row and a nonzero weight; bucketed/pinned like C so serving keeps
        one compiled shape."""
        pairs = int(
            ((plan_ints[3] < self.n_light) & (plan_ints[5] != 0)).sum()
        )
        return _pick_shape(
            max(pairs, 1), self.L_BUCKETS,
            self._pin("L", int(plan_ints.shape[1])), "L",
        )

    def _heavy_budget(self, plan_ints) -> int:
        """Static live heavy-pair count H2 for the v5 compact rescore.

        Pairs are (query, slot) with a live dense row and a nonzero
        weight; bucketed/pinned like L so serving keeps one compiled
        shape."""
        pairs = int(
            ((plan_ints[2] < self.n_dense) & (plan_ints[5] != 0)).sum()
        )
        return _pick_shape(
            max(pairs, 1), self.HP_BUCKETS,
            self._pin("HP", int(plan_ints.shape[1])), "HP",
        )

    def _chunk_budget(self, dfs, block) -> int:
        """Static chunk count C for this batch (device expansion never drops)."""
        total = int(np.sum((dfs.astype(np.int64) + block - 1) // block))
        return _pick_shape(
            total, self.config.device.chunk_buckets,
            self._pin("C", int(dfs.shape[0])), "C",
        )

    def _host_rescue_row(self, out, j, queries, K):
        """Overwrite packed row j with the exact host-oracle result for
        queries[j] (guard-trip rescue; oracle_search_vec is bit-identical
        to the device's exact path).

        The result is memoized by (query terms, K): guard trips are
        query-shape-deterministic (e.g. a 2-term query of two df~N terms
        whose near-uniform sums the guard provably cannot separate — the
        tools-built corpus trips on the SAME query every time it recurs,
        40-50 ms of host oracle each). A memo hit answers the repeat at
        plan time with zero device work, like the 1-term shortcut memo."""
        from .oracle import oracle_search_vec

        hits, found = oracle_search_vec(
            self._oracle_segs(), queries[j], K,
            k1=self.config.bm25.k1, b=self.config.bm25.b,
        )
        out[j, : 2 * K + 1] = 0.0
        scores = np.zeros(K, np.float32)
        slots = np.full(K, 2**30, np.int32)
        for i, (score, seg_idx, doc) in enumerate(hits[:K]):
            out[j, i] = np.float32(score)
            slot = self.doc_bases[seg_idx] + doc
            out[j, K + i] = np.float32(slot)
            scores[i] = np.float32(score)
            slots[i] = slot
        out[j, 2 * K] = np.float32(found)
        live = scores > 0
        memo = self._rescue_memo
        if len(memo) >= 100_000:
            memo.clear()
        memo[(tuple(queries[j]), K)] = QueryResult(
            scores=scores[live], doc_slots=slots[live], found=int(found)
        )

    def _oracle_segs(self):
        """Lazy host-side oracle segment views (guard-trip rescue)."""
        segs = getattr(self, "_oracle_segs_cache", None)
        if segs is None:
            segs = [s.to_oracle_segment() for s in self.segments]
            self._oracle_segs_cache = segs
        return segs

    def _query_windows(self, queries) -> np.ndarray:
        """Per-query summed light dfs (= the query's contiguous run length
        in the flat sorted light array). One lexicon probe; no device
        work."""
        rows_all, _ws, q_lens = _probe_queries_flat(
            self._lex_slices, queries
        )
        ent = self._lex_table[rows_all]
        dfs = np.where(ent[:, 2] < 0, ent[:, 1], 0).astype(np.int64)
        qi = np.repeat(np.arange(len(queries), dtype=np.int64), q_lens)
        w = np.zeros(len(queries), np.int64)
        np.add.at(w, qi, dfs)
        return w

    def _chunk_plan(self, starts, dfs, weights, block):
        """Flatten (query, slot) pairs into fixed-size posting chunks.

        Vectorized host planning; the chunk count is padded to a bucket from
        config.device.chunk_buckets so the kernel keeps one static shape.
        """
        Qb, T = starts.shape
        qi, ti = np.nonzero(dfs)
        df = dfs[qi, ti].astype(np.int64)
        reps = (df + block - 1) // block
        total = int(reps.sum())

        C = _pick_shape(
            total, self.config.device.chunk_buckets,
            self._pin("C", Qb), "C",
        )

        chunk_start = np.zeros(C, np.int32)
        chunk_len = np.zeros(C, np.int32)
        chunk_q = np.full(C, Qb, np.int32)  # out-of-range row -> dropped
        chunk_w = np.zeros(C, np.float32)
        if total:
            cum = np.cumsum(reps)
            owner = np.searchsorted(cum, np.arange(total), "right")
            within = np.arange(total) - (cum[owner] - reps[owner])
            s_rep = starts[qi, ti].astype(np.int64)[owner]
            df_rep = df[owner]
            chunk_start[:total] = s_rep + within * block
            chunk_len[:total] = np.minimum(block, df_rep - within * block)
            chunk_q[:total] = qi[owner]
            chunk_w[:total] = weights[qi, ti][owner]
        return chunk_start, chunk_len, chunk_q, chunk_w

    # ---------------- result mapping ----------------

    def hbm_bytes(self) -> Dict[str, int]:
        """Device (HBM) footprint of the serving index, bytes by component.

        BASELINE.json's north star reads "at equal index memory"; the
        reference's disk index is ~8 B/posting (src/api_engine.cpp:473-481
        reads two u32 per posting) plus the in-RAM lexicon. Our postings
        match that 8 B/posting exactly (post_doc i32 + post_score f32);
        everything else (dense score rows, bucket/position tables) is a
        throughput/memory tradeoff reported here so the bench can publish
        QPS per memory point.
        """
        out: Dict[str, int] = {}
        for name in (
            "post_doc", "post_score", "dense_rows", "bucket_pos",
            "light_bucket_pos",
        ):
            arr = getattr(self, name, None)
            if arr is not None:
                out[name] = int(arr.nbytes)
        out["total"] = sum(out.values())
        return out

    def locate(self, doc_slot: int) -> Tuple[int, int]:
        """Global doc slot -> (segment index, local docId)."""
        seg_idx = int(np.searchsorted(self._doc_bases_np, doc_slot, "right") - 1)
        return seg_idx, int(doc_slot - self.doc_bases[seg_idx])

    @property
    def _doc_bases_np(self) -> np.ndarray:
        arr = getattr(self, "_doc_bases_arr", None)
        if arr is None or arr.shape[0] != len(self.doc_bases):
            arr = np.asarray(self.doc_bases, np.int64)
            self._doc_bases_arr = arr
        return arr

    def doc_info_batch(self, slots: np.ndarray):
        """Vectorized doc_info for one query's hit slots: list of
        (segment name, cord_uid, local docId). The per-hit locate() costs
        one array build + searchsorted each (~5120 calls per 512-query
        render at k=10)."""
        slots = np.asarray(slots, np.int64)
        seg_idx = np.searchsorted(self._doc_bases_np, slots, "right") - 1
        out = []
        for si, slot in zip(seg_idx, slots):
            si = int(si)
            did = int(slot - self.doc_bases[si])
            out.append((self.seg_names[si], self.segments[si].cord_uids[did], did))
        return out

    def doc_info(self, doc_slot: int) -> Tuple[str, str, int]:
        """Global doc slot -> (segment name, cord_uid, local docId)."""
        seg_idx, doc_id = self.locate(doc_slot)
        return self.seg_names[seg_idx], self.segments[seg_idx].cord_uids[doc_id], doc_id
