"""Sharded multi-segment BM25 execution over a (dp, seg) device mesh.

This is the framework's distributed backend (SURVEY.md §5): segments are
grouped into `seg`-axis shards, each holding its own posting arrays and doc
slots; the query batch is sharded over the `dp` axis. Each device scores its
local shard (ops/bm25.py exact accumulation), takes a local top-K, and the
K-candidate lists are merged across the `seg` axis with an all_gather +
re-top-K — the device version of the reference's global top-K heap over
segments (src/api_engine.cpp:441-505). `found` counts are combined with a
psum. All collectives run inside one shard_map'd jit program (NCCL over
NVLink between the cards of one host).

Doc-slot layout: global slot = shard_id * shard_capacity + local slot, with
shards holding contiguous segment ranges in order, so ties still break in the
canonical (segment asc, docId asc) order after the merge.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import DEFAULT_CONFIG, EngineConfig
from ..index.builder import SegmentArrays, eager_scores
from ..index.segment import (
    QueryResult,
    WeightedTerm,
    _bucket,
    _pick_shape,
    _probe_queries_flat,
    _round_up,
)
from ..ops.bm25 import score_only_exact


def _sharded_search_fn(
    mesh: Mesh,
    n_slots: int,
    K: int,
    block: int,
    T: int,
    U: int,
    mode: str = "fused",
    K2: int = 32,
    C: int = 1024,
    bs_steps: int = 8,
    nd: int = 0,
    nl: int = 0,
    heavy_direct: bool = False,
    use_compact: bool = False,
    fast_heavy: bool = False,
    guard_eps: float = 2e-3,
    L2: int = 0,
    H2: int = 0,
):
    """Build the jit'd shard_map search step for a given mesh/static shapes.

    Each shard expands its (query, term) plan into posting chunks on device,
    scores them with its local mode (fused scatter or the full sparse
    pipeline), takes a local top-K2, exactly rescores those candidates, and
    the K2-candidate lists are merged across the seg axis with an
    all_gather + canonical sort. On a 1-shard mesh the merge is skipped
    entirely — local results are already canonically sorted.

    Transfer-minimal: the whole plan arrives as ONE int32 upload
    `plan [S, Qb, L]` (f32 payloads travel as raw bit patterns — pure
    bitcast; BM25 weights are normal floats, never denormal) and results
    leave as ONE packed f32 download [Qb, 2K+1] (vals | global doc slots |
    found — slots and found as exact f32 values, which caps the global
    slot space at 2^24, checked at index build). Row layout:
      sparse: L = 5T   starts | light_dfs | slot_dense | slot_light | wbits
      fused:  L = 4T+2U starts | dfs | light_dfs | wbits | mixbits |
              unique-heavy ids (group-first row only)
    """
    from ..ops.bm25 import (
        canonical_sort,
        exact_rescore,
        expand_chunks,
        heavy_scores,
        scatter_scores,
        tiled_topk,
    )
    from ..ops.bm25_sparse import _packed_impl

    S = mesh.shape["seg"]

    def local_step(post_doc, post_score, dense_rows, bucket_pos,
                   light_bucket_pos, plan):
        # Block shapes: post_* [1, P_shard], dense [1, Hpad, cap]
        # (sparse: [1, Hpad, cap/128, 128]), bucket_pos [1, H+1, NBh+1],
        # light_bucket_pos [1, NL+1, NBl+1], plan [1, Qd, L]
        post_doc = post_doc[0]
        post_score = post_score[0]
        pi = plan[0]
        starts = pi[:, :T]
        Qd = starts.shape[0]
        guard = None
        if mode == "sparse":
            # The shard-local step IS the single-device production kernel
            # (ops/bm25_sparse._packed_impl) over local doc slots: compact
            # row gather + guarded TF32 heavy matmul (or the exact f32
            # wide pool when fast_heavy=False), sort+segsum light chain,
            # compact exact rescore. One pipeline to maintain;
            # the sharded path inherits every single-chip optimization.
            plan7 = jnp.transpose(pi.reshape(Qd, 7, T), (1, 0, 2))
            out = _packed_impl(
                post_doc, post_score, dense_rows[0], bucket_pos[0],
                light_bucket_pos[0], plan7,
                n_slots=n_slots, K=K, K2=K2, C=C, block=block,
                bs_steps=bs_steps, nd=nd, nl=nl, U=U,
                use_compact=use_compact,
                heavy_direct=heavy_direct, fast_heavy=fast_heavy,
                guard_eps=guard_eps, L2=L2, H2=H2,
            )
            vals = out[:, :K]
            idx = out[:, K : 2 * K].astype(jnp.int32)
            found = out[:, 2 * K].astype(jnp.int32)
            if fast_heavy:
                guard = out[:, 2 * K + 1]
            k2 = K
            scores = None
        elif mode == "exact":
            dfs = pi[:, T : 2 * T]
            weights = lax.bitcast_convert_type(
                pi[:, 3 * T : 4 * T], jnp.float32
            )
            scores = score_only_exact(
                post_doc, post_score, starts, dfs, weights,
                n_slots=n_slots, block=block,
            )
            k2 = min(K, n_slots)
            vals, idx = lax.top_k(scores, k2)
        else:
            dfs = pi[:, T : 2 * T]
            light_dfs = pi[:, 2 * T : 3 * T]
            weights = lax.bitcast_convert_type(
                pi[:, 3 * T : 4 * T], jnp.float32
            )
            heavy_mix = lax.bitcast_convert_type(
                pi[:, 4 * T : 4 * T + U], jnp.float32
            )
            unique_heavy = pi[0, 4 * T + U :]
            cs, cl, cq, cw = expand_chunks(
                starts, light_dfs, weights, C=C, block=block
            )
            scores = scatter_scores(
                post_doc, post_score, cs, cl, cq, cw,
                Q=Qd, n_slots=n_slots, block=block,
            )
            scores = scores + heavy_scores(
                dense_rows[0], unique_heavy, heavy_mix
            )
            k2 = min(K2, n_slots)
            _fv, idx = tiled_topk(scores, k2)
            exact = exact_rescore(
                post_doc, post_score, starts, dfs, weights, idx.astype(jnp.int32)
            )
            vals, idx = canonical_sort(exact, idx.astype(jnp.int32))
        if mode != "sparse":
            found = jnp.sum(scores > 0, axis=1, dtype=jnp.int32)
            k2 = vals.shape[1]

        shard_id = lax.axis_index("seg")
        gidx = jnp.where(
            vals > 0, idx.astype(jnp.int32) + shard_id * n_slots, jnp.int32(2**30)
        )

        if S > 1:
            # Merge across the seg axis: gather all shards' candidates,
            # re-rank canonically by (score desc, global slot asc).
            all_vals = lax.all_gather(vals, "seg", axis=0)  # [S, Qd, k2]
            all_idx = lax.all_gather(gidx, "seg", axis=0)
            cat_vals = jnp.transpose(all_vals, (1, 0, 2)).reshape(Qd, S * k2)
            cat_idx = jnp.transpose(all_idx, (1, 0, 2)).reshape(Qd, S * k2)
            mvals, midx = canonical_sort(cat_vals, cat_idx)
            total_found = lax.psum(found, "seg")
            if guard is not None:
                # The fast path's per-shard proof: every doc a shard
                # excluded has true score <= (1+eps)*tau_shard, so the
                # MERGED top-K is proven iff every shard's guard passed
                # (min over the seg axis).
                guard = lax.pmin(guard, "seg")
        else:
            # 1 shard: local results are already canonically sorted; the
            # gather + re-sort would be pure overhead.
            mvals, midx = vals, gidx
            total_found = found
        k_out = min(K, S * k2)
        cols = [
            mvals[:, :k_out],
            midx[:, :k_out].astype(jnp.float32),
            total_found[:, None].astype(jnp.float32),
        ]
        if guard is not None:
            cols.append(guard[:, None])
        packed = jnp.concatenate(cols, axis=1)
        return packed[None]

    from jax import shard_map

    fn = shard_map(
        local_step,
        mesh=mesh,
        in_specs=(
            P("seg", None),  # post_doc    [S, P_shard]
            P("seg", None),  # post_score  [S, P_shard]
            P("seg", None, None),  # dense_rows [S, Hpad, cap]
            P("seg", None, None),  # bucket_pos [S, H+1, NBh+1]
            P("seg", None, None),  # light_bucket_pos [S, NL+1, NBl+1]
            P("seg", "dp", None),  # plan [S, Qb, L]
        ),
        out_specs=P(None, "dp", None),
        check_vma=False,
    )

    def step(post_doc, post_score, dense_rows, bucket_pos,
             light_bucket_pos, plan):
        packed = fn(
            post_doc, post_score, dense_rows, bucket_pos,
            light_bucket_pos, plan,
        )
        return packed[0]

    return jax.jit(step)


class ShardedIndex:
    """Multi-segment index sharded over a (dp, seg) mesh.

    Segments are assigned to seg-shards round-robin by contiguous ranges
    (shard i gets segments [cuts[i], cuts[i+1])); every shard's arrays are
    padded to common capacities so shard_map blocks have equal shapes.
    """

    T_BUCKETS = (4, 8, 16, 32, 64, 128, 256)
    K_BUCKETS = (10, 32, 100)
    L_BUCKETS = (128, 256, 512, 1024, 2048, 4096, 8192)
    HP_BUCKETS = (128, 256, 512, 1024, 2048, 4096, 8192)

    def __init__(
        self,
        segments: Sequence[SegmentArrays],
        mesh: Mesh,
        seg_names: Optional[Sequence[str]] = None,
        config: EngineConfig = DEFAULT_CONFIG,
    ):
        self.config = config
        self.mesh = mesh
        self.segments = list(segments)
        self.seg_names = list(seg_names) if seg_names else [
            f"seg_{i + 1:06d}" for i in range(len(self.segments))
        ]
        self.dp = mesh.shape["dp"]
        self.n_shards = mesh.shape["seg"]
        S = self.n_shards

        # Contiguous segment ranges per shard, balanced by doc count.
        n_segs = len(self.segments)
        doc_counts = [s.N for s in self.segments]
        total_docs = sum(doc_counts)
        cuts = [0]
        acc = 0
        for i, c in enumerate(doc_counts):
            acc += c
            # close the shard when it reached its fair share (keep S ranges)
            while len(cuts) < S and acc >= total_docs * len(cuts) / S and i + 1 <= n_segs:
                cuts.append(i + 1)
        while len(cuts) < S:
            cuts.append(n_segs)
        cuts.append(n_segs)
        self.shard_seg_ranges = [(cuts[i], cuts[i + 1]) for i in range(S)]

        # Per-shard layouts.
        # lex value: term -> (local posting start, df, dense_row_id or -1)
        self.shard_doc_bases: List[List[int]] = []  # local doc base per segment
        shard_docs: List[int] = []
        shard_posts: List[int] = []
        self.lex: List[List[dict]] = []
        for si, (lo, hi) in enumerate(self.shard_seg_ranges):
            dbase = 0
            pbase = 0
            bases = []
            lexes = []
            for seg in self.segments[lo:hi]:
                bases.append(dbase)
                lex = {}
                offs = seg.term_offsets
                for i, t in enumerate(seg.terms):
                    lex[t] = (pbase + int(offs[i]), int(seg.term_df[i]), -1)
                lexes.append(lex)
                dbase += seg.N
                pbase += seg.num_postings
            self.shard_doc_bases.append(bases)
            self.lex.append(lexes)
            shard_docs.append(dbase)
            shard_posts.append(pbase)

        dpad = config.device.doc_pad
        self._sparse = config.device.mode == "sparse"
        if self._sparse:
            # sparse mode tiles the doc axis in 2048-doc count tiles
            # (ops/heavy.TILE); keep every shard's capacity aligned.
            # round_up, not max: a configured doc_pad that is a larger
            # non-multiple of 2048 (e.g. 3072) must still yield a
            # TILE-aligned shard capacity (heavy kernels reshape
            # (Q, n_tiles, 2048)).
            dpad = _round_up(dpad, 2048)
        self.shard_capacity = max(_round_up(max(shard_docs or [1], default=1), dpad), dpad)
        if S * self.shard_capacity >= 1 << 24:
            # The packed result download carries global doc slots as exact
            # f32 values (one transfer); past 2^24 that representation
            # loses integers.
            raise ValueError(
                f"global slot space {S}x{self.shard_capacity} exceeds the "
                "2^24 exact-f32 packed-transport bound; use more/larger "
                "shards or raise doc_pad granularity"
            )
        p_capacity = max(max(shard_posts) if shard_posts else 1, 1)

        post_doc = np.zeros((S, p_capacity), np.int32)
        post_score_parts: List[List[np.ndarray]] = []
        post_score = np.zeros((S, p_capacity), np.float32)
        for si, (lo, hi) in enumerate(self.shard_seg_ranges):
            pb = 0
            scores_here = []
            for j, seg in enumerate(self.segments[lo:hi]):
                n = seg.num_postings
                post_doc[si, pb : pb + n] = seg.post_doc + self.shard_doc_bases[si][j]
                sc = seg.post_score
                if sc is None:
                    sc = eager_scores(seg, k1=config.bm25.k1, b=config.bm25.b)
                post_score[si, pb : pb + n] = sc
                scores_here.append(sc)
                pb += n
            post_score_parts.append(scores_here)
        # Padding rows: doc slot 0 with score 0 — harmless (df masks them off).

        # Per-shard dense rows for heavy terms (same hybrid representation as
        # DeviceIndex, padded to a common H so shard blocks match).
        dcfg = config.device
        self.dense_threshold = (
            max(1, int(self.shard_capacity * dcfg.dense_df_ratio))
            if dcfg.dense_df_ratio > 0
            else (1 << 62)
        )
        # With f32 rows the sharded rescore reads heavy scores straight
        # off the dense block (heavy-direct rescore) — no heavy bucket
        # table — which also unlocks MERGED rows: classify by SHARD-
        # global df and scatter every segment's postings for the term
        # into ONE row (same bit-exactness argument as DeviceIndex: a
        # doc lives in one segment, the others contribute +0.0f). The
        # bf16-rows opt-in keeps per-(term, segment) rows + the bucket
        # table (its v2 rescore binary-searches one contiguous range).
        self._heavy_direct = self._sparse and not dcfg.dense_rows_bf16
        row_bytes = (2 if dcfg.dense_rows_bf16 else 4) * self.shard_capacity
        row_cap = min(
            dcfg.dense_max_rows,
            max(0, int(dcfg.dense_max_bytes // row_bytes)),
        )
        # per_shard_entries: scatter units (row_id, seg_j, term_i) —
        # many-to-one onto rows when merged, 1:1 otherwise.
        per_shard_entries: List[List[Tuple[int, int, int]]] = []
        per_shard_rows: List[int] = []
        # shard-global df per merged heavy term (the planning table's df
        # column for merged entries, and the 1-term-shortcut's exact
        # `found`; mirrors DeviceIndex._gdf)
        self._gdf_shard: List[Dict[str, int]] = []
        for si, (lo, hi) in enumerate(self.shard_seg_ranges):
            if self._heavy_direct:
                gdf: Dict[str, int] = {}
                where: Dict[str, List[Tuple[int, int]]] = {}
                for j, seg in enumerate(self.segments[lo:hi]):
                    for i, t in enumerate(seg.terms):
                        df = int(seg.term_df[i])
                        if df > 0:
                            gdf[t] = gdf.get(t, 0) + df
                            where.setdefault(t, []).append((j, i))
                heavy_terms = sorted(
                    ((d, t) for t, d in gdf.items()
                     if d >= self.dense_threshold),
                    reverse=True,
                )[:row_cap]
                entries = [
                    (row_id, j, i)
                    for row_id, (_d, t) in enumerate(heavy_terms)
                    for j, i in where[t]
                ]
                per_shard_rows.append(len(heavy_terms))
                self._gdf_shard.append(
                    {t: d for d, t in heavy_terms}
                )
            else:
                heavy = []
                for j, seg in enumerate(self.segments[lo:hi]):
                    for i, t in enumerate(seg.terms):
                        df = int(seg.term_df[i])
                        if df >= self.dense_threshold:
                            heavy.append((df, j, i))
                heavy.sort(reverse=True)
                heavy = heavy[:row_cap]
                entries = [
                    (row_id, j, i) for row_id, (_df, j, i) in enumerate(heavy)
                ]
                per_shard_rows.append(len(heavy))
                self._gdf_shard.append({})
            per_shard_entries.append(entries)
        self.n_dense = max(per_shard_rows, default=0)
        # Row-pad the dense block to a multiple of 8 in sparse mode (an
        # aligned matmul operand); pad rows are all-zero and the mix never
        # references them.
        h_rows = self.n_dense + 1
        if self._sparse:
            h_rows = _round_up(h_rows, 8)
        dense_host = np.zeros(
            (S, h_rows, self.shard_capacity), np.float32
        )
        for si, entries in enumerate(per_shard_entries):
            lo, _hi = self.shard_seg_ranges[si]
            for row_id, j, term_i in entries:
                seg = self.segments[lo + j]
                a = int(seg.term_offsets[term_i])
                b = int(seg.term_offsets[term_i + 1])
                docs = seg.post_doc[a:b].astype(np.int64) + self.shard_doc_bases[si][j]
                dense_host[si, row_id, docs] = post_score_parts[si][j][a:b]
                term = seg.terms[term_i]
                start, dfv, _ = self.lex[si][j][term]
                self.lex[si][j][term] = (start, dfv, row_id)

        # Sparse-mode rescore bucket tables, per shard (host-built: shard
        # arrays are host-resident here; the single-chip DeviceIndex uses
        # the on-device build in index/device_build.py).
        from ..ops.bm25_sparse import BUCKET_LOG2, LIGHT_BUCKET_LOG2

        self._light_row: List[List[dict]] = []  # [shard][seg] term -> row
        self.n_light = 0
        bucket_host = None
        light_host = None
        self._bs_depth = 2
        if self._sparse:
            cap = self.shard_capacity
            nbh = (cap + (1 << BUCKET_LOG2) - 1) >> BUCKET_LOG2
            nbl = (cap + (1 << LIGHT_BUCKET_LOG2) - 1) >> LIGHT_BUCKET_LOG2
            max_occ = 0
            if not self._heavy_direct:
                # heavy bucket table: only the bf16-rows opt-in's v2
                # rescore searches heavy posting ranges
                bucket_host = np.zeros(
                    (S, self.n_dense + 1, nbh + 1), np.int32
                )
                bounds_h = np.arange(nbh + 1, dtype=np.int64) << BUCKET_LOG2
                for si, entries in enumerate(per_shard_entries):
                    lo, _hi = self.shard_seg_ranges[si]
                    for row_id, j, term_i in entries:
                        seg = self.segments[lo + j]
                        a = int(seg.term_offsets[term_i])
                        b = int(seg.term_offsets[term_i + 1])
                        docs = (
                            seg.post_doc[a:b].astype(np.int64)
                            + self.shard_doc_bases[si][j]
                        )
                        row = np.searchsorted(
                            docs, bounds_h, "left"
                        ).astype(np.int32)
                        bucket_host[si, row_id] = row
                        max_occ = max(
                            max_occ, int(np.diff(row).max(initial=0))
                        )
            # light row assignment + per-shard light bucket tables
            shard_counts: List[np.ndarray] = []
            n_light_per_shard: List[int] = []
            for si, (lo, hi) in enumerate(self.shard_seg_ranges):
                maps = []
                rows_here = 0
                cnts = []
                for j, seg in enumerate(self.segments[lo:hi]):
                    lex = self.lex[si][j]
                    m = {}
                    for i, t in enumerate(seg.terms):
                        start, df, dense_id = lex[t]
                        if df > 0 and dense_id < 0:
                            m[t] = rows_here
                            docs = (
                                seg.post_doc[
                                    int(seg.term_offsets[i]) : int(
                                        seg.term_offsets[i + 1]
                                    )
                                ].astype(np.int64)
                                + self.shard_doc_bases[si][j]
                            )
                            c = np.bincount(
                                docs >> LIGHT_BUCKET_LOG2, minlength=nbl
                            )[:nbl]
                            cnts.append(c.astype(np.int32))
                            rows_here += 1
                    maps.append(m)
                self._light_row.append(maps)
                n_light_per_shard.append(rows_here)
                shard_counts.append(
                    np.stack(cnts)
                    if cnts
                    else np.zeros((0, nbl), np.int32)
                )
            self.n_light = max(n_light_per_shard, default=0)
            light_host = np.zeros(
                (S, self.n_light + 1, nbl + 1), np.int32
            )
            for si, cnts in enumerate(shard_counts):
                if cnts.shape[0]:
                    max_occ = max(max_occ, int(cnts.max(initial=0)))
                    np.cumsum(
                        cnts, axis=1,
                        out=light_host[si, : cnts.shape[0], 1:],
                    )
            self._bs_depth = max(2, int(max(max_occ, 1)).bit_length())

        post_spec = NamedSharding(mesh, P("seg", None))
        self.post_doc = jax.device_put(post_doc, post_spec)
        self.post_score = jax.device_put(post_score, post_spec)
        self._build_row_topk(dense_host, per_shard_rows)
        self._build_light_topk(post_doc, post_score)
        if dcfg.dense_rows_bf16:
            import ml_dtypes

            dense_host = dense_host.astype(ml_dtypes.bfloat16)
        if self._sparse:
            # sparse mode stores the per-shard dense block 3D
            # [rows, cap/128, 128] (like DeviceIndex);
            # shard_capacity is 2048-aligned, hence % 128 == 0.
            dense_host = dense_host.reshape(
                S, h_rows, self.shard_capacity // 128, 128
            )
            self.dense_rows = jax.device_put(
                dense_host, NamedSharding(mesh, P("seg", None, None, None))
            )
        else:
            self.dense_rows = jax.device_put(
                dense_host, NamedSharding(mesh, P("seg", None, None))
            )
        tab_spec = NamedSharding(mesh, P("seg", None, None))
        self.bucket_pos = (
            jax.device_put(bucket_host, tab_spec)
            if bucket_host is not None
            else None
        )
        self.light_bucket_pos = (
            jax.device_put(light_host, tab_spec)
            if light_host is not None
            else None
        )
        self.n_docs = total_docs
        self._fns = {}
        # Pinned static shapes (pin_shapes): {"T","Q","C","U"} -> int.
        self._pins = {}
        # Per-Q-envelope pins (pin_shapes(scope_q=True)): Qb -> {T,C,U};
        # same contract as DeviceIndex._qpins (scoped pins win).
        self._qpins = {}
        # (term, k) -> QueryResult|None for w==1 1-term shortcut answers
        self._shortcut_memo = {}
        self._build_merged_lex()

    def _build_row_topk(self, dense_host, per_shard_rows) -> None:
        """Precompute exact canonical top-k of the df-head dense rows,
        per shard (host-side analog of DeviceIndex._build_row_topk; the
        shard arrays are host-resident at build time here).

        A 1-term query on a term that is heavy in EVERY shard it touches
        is a pure function of its merged dense rows — answered host-side
        with zero device work and zero fast-path guard trips (df~N terms'
        10th..K2th scores sit inside the guard margin, where the proof
        provably cannot pass; without this, every 1M-scale batch carrying
        one such query would relaunch the wide kernel).

        Canonical (score desc, slot asc) tie order is exact: positive f32
        score bit patterns are order-isomorphic to uint32, and local slots
        fit 24 bits (checked against the packed-transport bound), so one
        uint64 key (score_bits << 24 | ~slot) makes top-k tie-free."""
        self._row_topk = None
        dcfg = self.config.device
        if not (self._sparse and self._heavy_direct):
            return
        k = min(dcfg.row_topk_k, self.shard_capacity)
        if dcfg.row_topk_rows <= 0 or k <= 0:
            return
        cap = self.shard_capacity
        slot_mask = (1 << 24) - 1
        per_shard: List[Optional[Tuple[np.ndarray, np.ndarray]]] = []
        for si in range(self.n_shards):
            n = min(per_shard_rows[si], dcfg.row_topk_rows)
            if n <= 0:
                per_shard.append(None)
                continue
            rows = dense_host[si, :n]  # [n, cap] f32, >= 0
            key = rows.view(np.uint32).astype(np.uint64) << np.uint64(24)
            key |= np.uint64(slot_mask) - np.arange(cap, dtype=np.uint64)
            part = np.argpartition(key, cap - k, axis=1)[:, cap - k :]
            pk = np.take_along_axis(key, part, axis=1)
            order = np.argsort(pk, axis=1)[:, ::-1]  # key desc = canonical
            slots = np.take_along_axis(part, order, axis=1).astype(np.int32)
            vals = np.take_along_axis(rows, slots, axis=1).astype(np.float32)
            per_shard.append((vals, slots))
        if any(p is not None for p in per_shard):
            self._row_topk = per_shard

    def _build_light_topk(self, post_doc, post_score) -> None:
        """Precompute exact canonical top-k per light (term, segment)
        posting range, per shard (DeviceIndex._build_light_topk over the
        shard-local posting arrays; slots stored LOCAL, globalized at
        serve). Same uint64 (score_bits << 24 | ~slot) key trick — local
        slots fit 24 bits by the packed-transport bound."""
        self._light_topk = None
        dcfg = self.config.device
        kl = dcfg.light_topk_k
        if (
            not self._sparse
            or kl <= 0
            or self.n_light == 0
            or self.shard_capacity >= 1 << 24
        ):
            return
        kl = min(kl, self.shard_capacity)
        vals = np.zeros((self.n_shards, self.n_light, kl), np.float32)
        slots = np.full((self.n_shards, self.n_light, kl), 2**30, np.int32)
        mask24 = np.uint64((1 << 24) - 1)
        for si in range(self.n_shards):
            lmaps = self._light_row[si]
            items = []  # (row, local start, df) row-ascending
            for j, lmap in enumerate(lmaps):
                lex = self.lex[si][j]
                for t, row in lmap.items():
                    st, df, _r = lex[t]
                    items.append((row, st, df))
            if not items:
                continue
            items.sort()
            rows_arr = np.asarray([r for r, _s, _d in items], np.int64)
            starts = np.asarray([s for _r, s, _d in items], np.int64)
            dfs = np.asarray([d for _r, _s, d in items], np.int64)
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
            sc = np.ascontiguousarray(post_score[si][pos], np.float32)
            doc = post_doc[si][pos].astype(np.int64)
            key_inv = ~(
                (sc.view(np.uint32).astype(np.uint64) << np.uint64(24))
                | (mask24 - doc.astype(np.uint64))
            )
            order = np.lexsort((key_inv, rep))
            off = cum - dfs
            take = np.minimum(dfs, kl)
            sel_rows = np.repeat(np.arange(len(items)), take)
            within = np.arange(int(take.sum())) - np.repeat(
                np.cumsum(take) - take, take
            )
            src = order[off[sel_rows] + within]
            vals[si, rows_arr[sel_rows], within] = sc[src]
            slots[si, rows_arr[sel_rows], within] = doc[src]
        self._light_topk = (vals, slots)

    def _shortcut_single_heavy(self, queries, k: int):
        """Answer 1-term head-heavy queries from the per-shard row top-k.

        Returns (queries, fills) with the DeviceIndex._shortcut contract:
        shortcut queries are replaced by [] (their plan slots empty out;
        the batch envelope is unchanged) and fills maps batch index ->
        finished QueryResult. Eligible terms are heavy (merged dense row
        inside the precomputed head) in EVERY shard occurrence; `found`
        is the sum of shard-global dfs (exact: a doc lives in one shard).
        The merged global top-k of per-shard canonical prefixes stays
        exact and canonical: scores merge by (score desc, GLOBAL slot
        asc), matching the kernel's cross-shard tie order. For w != 1 the
        multiply may collapse distinct f32 values; each shard prefix must
        then keep its k-th value strictly above its stored tail or we
        fall back to the kernel (same rule as DeviceIndex).

        Terms light in EVERY shard occurrence are answered the same way
        from the per-shard light posting top-k (exact for
        k <= light_topk_k, incomplete-prefix boundary rule per
        occurrence); mixed heavy/light terms keep the kernel path.

        w == 1 results (the entire organic 1-term stream: expansion
        produces multi-term queries, so off-1 weights never reach here)
        are memoized per (term, k) — Zipf query streams repeat head
        terms constantly, and the memo turns the numpy merge into one
        dict probe per query. QueryResults are shared across hits; they
        are read-only downstream."""
        rt = getattr(self, "_row_topk", None)
        lt = getattr(self, "_light_topk", None)
        if rt is None and lt is None:
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
                    res = self._shortcut_compute(t, w32, k, rt, lt)
                    if len(memo) >= 200_000:
                        memo.clear()
                    memo[key] = res
            else:
                res = self._shortcut_compute(t, w32, k, rt, lt)
            if res is None:
                continue
            if out is None:
                out = list(queries)
            fills[qi] = res
            out[qi] = []
        return (out, fills) if fills else (queries, None)

    def _shortcut_compute(self, t, w32, k, rt, lt):
        """One term's host-side 1-term answer, or None for the kernel
        path (see _shortcut_single_heavy for the exactness rules)."""
        oc = self._lex_slices.get(t)
        if oc is None:
            return None
        cap = self.shard_capacity
        ent = self._lex_table[oc[0] : oc[0] + oc[1]]
        d3 = ent[:, 3]
        heavy_all = bool((d3 >= 0).all())
        light_all = not heavy_all and bool((d3 < 0).all())
        if not (
            (heavy_all and rt is not None)
            or (light_all and lt is not None)
        ):
            return None  # mixed classification -> kernel path
        sv_all = []
        gs_all = []
        found = 0
        for si, _st, df, row, lrow in ent:
            if heavy_all:
                pt = rt[si]
                if pt is None or row >= pt[0].shape[0]:
                    return None
                vals, slots = pt[0][row], pt[1][row]
                df_cover = 0  # row prefix may be incomplete either way
            else:
                vals_l, slots_l = lt
                if lrow >= self.n_light:
                    return None
                vals, slots = vals_l[si, lrow], slots_l[si, lrow]
                df_cover = int(df)  # df <= width => prefix complete
            kp = vals.shape[0]
            if k > kp:
                return None
            sv = vals if w32 == np.float32(1.0) else w32 * vals
            if (
                w32 != np.float32(1.0)
                and not 0 < df_cover <= kp
                and not sv[min(k, kp) - 1] > sv[-1]
            ):
                return None  # multiply collapsed the prefix boundary
            sv_all.append(sv)
            gs_all.append(
                slots if si == 0 else slots.astype(np.int64) + si * cap
            )
            found += int(df)
        if len(sv_all) == 1 and w32 == np.float32(1.0):
            # a single stored prefix is already canonical (score desc,
            # slot asc; globalizing preserves slot order within a shard)
            sv, gs = sv_all[0], gs_all[0]
        else:
            sv = np.concatenate(sv_all)
            gs = np.concatenate(gs_all)
            order = np.lexsort((gs, -sv))
            sv = sv[order]
            gs = gs[order]
        live = sv > 0
        return QueryResult(
            scores=sv[live][:k].astype(np.float32),
            doc_slots=gs[live][:k].astype(np.int32),
            found=found,
        )

    def _build_merged_lex(self) -> None:
        """Merge all shard lexicons into one packed planning table.

        _lex_slices: term -> (offset, count) into _lex_table rows of
        (shard, local posting start, df, dense_row_id, light_row_id),
        ordered (shard asc, segment asc) per term — matching the canonical
        slot order. light_row_id indexes the shard's light_bucket_pos rows
        (n_light for heavy slots / non-sparse). Planning then costs one
        dict probe per (query, term) + NumPy gathers instead of a Python
        loop over every (shard, segment).
        """
        nl = self.n_light
        merged = getattr(self, "_heavy_direct", False)
        occ: Dict[str, List[Tuple[int, int, int, int, int]]] = {}
        for si, shard_lexes in enumerate(self.lex):
            lmaps = self._light_row[si] if self._light_row else None
            seen_heavy: set = set()
            for j, lex in enumerate(shard_lexes):
                lmap = lmaps[j] if lmaps else {}
                for t, v in lex.items():
                    if v[1] > 0:
                        df = v[1]
                        if merged and v[2] >= 0:
                            # merged dense row: ONE planning slot per
                            # (term, shard) — a second slot would add
                            # the weight to the same row twice. Its df
                            # column carries the SHARD-global df (the
                            # 1-term shortcut's exact `found`; the
                            # kernel never reads heavy dfs).
                            if t in seen_heavy:
                                continue
                            seen_heavy.add(t)
                            df = self._gdf_shard[si].get(t, df)
                        occ.setdefault(t, []).append(
                            (si, v[0], df, v[2], lmap.get(t, nl))
                        )
        n_rows = sum(len(v) for v in occ.values())
        table = np.zeros((max(n_rows, 1), 5), np.int64)
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
    # (mirrors index.segment.DeviceIndex so Engine/HybridIndex code works
    #  against either)

    def iter_lexicons(self):
        """Yield every per-segment lexicon dict across all shards."""
        for shard_lexes in self.lex:
            yield from shard_lexes

    @property
    def slot_capacity(self) -> int:
        """Size of the global doc-slot space (shard-major layout)."""
        return self.n_shards * self.shard_capacity

    def segment_slot_bases(self) -> List[int]:
        """Global doc-slot base per segment, aligned with self.segments."""
        bases = [0] * len(self.segments)
        for si, (lo, hi) in enumerate(self.shard_seg_ranges):
            for j in range(hi - lo):
                bases[lo + j] = (
                    si * self.shard_capacity + self.shard_doc_bases[si][j]
                )
        return bases

    # ---------------- planning ----------------

    def _flatten_probe(self, queries):
        """Shared vectorized front half of both planners.

        Returns (ent, w, qi, slot, T, Qb) over ALL (query, term-slot,
        shard-occurrence) triples flattened: ent = merged-table rows
        [n, 5], w = weights, qi = query index, slot = per-(query, shard)
        term-slot rank (original probe order — term order then shard-asc
        occurrence order, matching the canonical slot layout), T/Qb the
        static plan shapes. Pure NumPy — no per-(query, shard) Python
        loop (VERDICT r2 item 8: at many-shard/large-batch scale the old
        loop was host wall time per batch).
        """
        S = self.n_shards
        table = self._lex_table
        # Flat probe: ONE numpy expansion for the whole batch. The
        # per-query list-of-arrays variant costs ~10 small numpy calls
        # per query — measured 22 ms of serial host time at batch 512,
        # which was most of the sharded (1,1) 24.6% QPS overhead vs
        # DeviceIndex (planning is serial with the launch pipeline on a
        # 1-core serving host).
        rows, w, q_lens = _probe_queries_flat(self._lex_slices, queries)
        qi = np.repeat(np.arange(len(queries), dtype=np.int64), q_lens)
        ent = table[rows]
        sid = ent[:, 0]

        # Rank within each (query, shard) group, preserving flat order:
        # stable-sort by group key, subtract each group's start position.
        key = qi * S + sid
        order = np.argsort(key, kind="stable")
        ks = key[order]
        grp_first = np.concatenate([[True], ks[1:] != ks[:-1]])
        grp_start = np.where(grp_first, np.arange(ks.shape[0]), 0)
        np.maximum.accumulate(grp_start, out=grp_start)
        slot = np.empty(ks.shape[0], np.int64)
        slot[order] = np.arange(ks.shape[0]) - grp_start

        t_max = int(slot.max()) + 1 if slot.shape[0] else 1
        Qb = _round_up(max(len(queries), 1), self.dp)
        if self._pins.get("Q"):
            Qb = _round_up(max(Qb, 1), self._pins["Q"])
        if self._qpins and Qb not in self._qpins:
            # An unwarmed batch size (engine cache hits shrink batches
            # below the warmed size) pads up to the nearest LARGER warmed
            # envelope and reuses its compiled shape instead of compiling
            # its own mid-serving.
            larger = [q for q in self._qpins if q > Qb]
            if larger:
                Qb = min(larger)
        T = _pick_shape(t_max, self.T_BUCKETS, self._pin("T", Qb), "T")
        # Occurrences past T slots are dropped (same truncation the
        # loop planner applied).
        keep = slot < T
        if not keep.all():
            ent, w, qi, slot = ent[keep], w[keep], qi[keep], slot[keep]
        return ent, w, qi, slot, T, Qb

    def plan(self, queries: Sequence[Sequence[WeightedTerm]]):
        """Per-shard padded term-slot plans + hybrid split.

        Returns (starts, dfs, weights, light_dfs) of shape [S, Qb, T] plus
        (unique_heavy [S, DP, U], heavy_mix [S, DP, Qd, U]) with dp-LOCAL
        query rows (shard_map splits the Qb axis into DP contiguous groups).
        """
        S = self.n_shards
        ent, w, qi, slot, T, Qb = self._flatten_probe(queries)
        Qd = Qb // self.dp
        sid = ent[:, 0]

        starts = np.zeros((S, Qb, T), np.int32)
        dfs = np.zeros((S, Qb, T), np.int32)
        weights = np.zeros((S, Qb, T), np.float32)
        light_dfs = np.zeros((S, Qb, T), np.int32)
        dense = ent[:, 3]
        light = dense < 0
        starts[sid, qi, slot] = ent[:, 1]
        dfs[sid, qi, slot] = ent[:, 2]
        weights[sid, qi, slot] = w
        light_dfs[sid, qi, slot] = np.where(light, ent[:, 2], 0)

        hb = self.config.device.heavy_buckets
        hm = ~light
        h_si = sid[hm]
        h_g, h_lq = np.divmod(qi[hm], Qd)
        h_id = ent[hm, 3]
        h_w = w[hm]
        if h_id.shape[0]:
            # unique dense ids per (shard, group)
            key = (h_si * self.dp + h_g) * (self.n_dense + 1) + h_id
            uniq_key, inv = np.unique(key, return_inverse=True)
            uk_sg, uk_id = divmod(uniq_key, self.n_dense + 1)
            # slot index within each (shard, group): rank among that group's
            # unique keys (uniq_key is sorted, so ranks are positional)
            grp_first = np.concatenate([[True], uk_sg[1:] != uk_sg[:-1]])
            grp_start = np.where(
                grp_first, np.arange(uk_sg.shape[0]), 0
            )
            np.maximum.accumulate(grp_start, out=grp_start)
            u_slot = np.arange(uniq_key.shape[0]) - grp_start
            u_max = int(u_slot.max()) + 1
        else:
            u_max = 0
        U = _pick_shape(u_max, hb, self._pin("U", Qb), "U")
        unique_heavy = np.full((S, self.dp, U), self.n_dense, np.int32)
        heavy_mix = np.zeros((S, self.dp, Qd, U), np.float32)
        if h_id.shape[0]:
            uk_s, uk_g = divmod(uk_sg, self.dp)
            unique_heavy[uk_s, uk_g, u_slot] = uk_id
            np.add.at(
                heavy_mix, (h_si, h_g, h_lq, u_slot[inv]), h_w
            )
        return starts, dfs, weights, light_dfs, unique_heavy, heavy_mix

    def plan_sparse(self, queries: Sequence[Sequence[WeightedTerm]]):
        """Sparse-mode per-shard plan in the single-device row layout.

        Returns (plan [S, Qb, 7T] int32, U). Per query the 7 contiguous
        T-column sections mirror DeviceIndex.plan_sparse's plan rows —
        starts / light_dfs / slot_dense (n_dense = light/padding) /
        slot_light (light_bucket_pos row; n_light = heavy/padding) /
        slot_compact (compact mix column; U = light/padding -> zero col) /
        weight f32 bit patterns / unique dense row ids (row-major, the
        first n_uniq of each (shard, dp-group)'s [Qd, T] block; sentinel
        n_dense) — so the shard-local step can run the SAME production
        kernel (ops/bm25_sparse._packed_impl) as the single-chip path,
        compact row gather included. U is the static compact-table
        bucket: max unique dense rows over (shard, dp-group), sized by the
        heavy_buckets ladder / the "U" pin.
        """
        S = self.n_shards
        ent, w, qi, slot, T, Qb = self._flatten_probe(queries)
        sid = ent[:, 0]
        Qd = Qb // self.dp
        nd = self.n_dense

        starts = np.zeros((S, Qb, T), np.int32)
        light_dfs = np.zeros((S, Qb, T), np.int32)
        slot_dense = np.full((S, Qb, T), nd, np.int32)
        slot_light = np.full((S, Qb, T), self.n_light, np.int32)
        wbits = np.zeros((S, Qb, T), np.int32)
        dense = ent[:, 3]
        light = dense < 0
        starts[sid, qi, slot] = ent[:, 1]
        light_dfs[sid, qi, slot] = np.where(light, ent[:, 2], 0)
        slot_dense[sid, qi, slot] = np.where(light, nd, dense)
        slot_light[sid, qi, slot] = np.where(light, ent[:, 4], self.n_light)
        wbits[sid, qi, slot] = w.view(np.int32)

        # Compact heavy-row table per (shard, dp-group) — the units a
        # shard_map block plans over (same unique-rank trick as plan()).
        hm = ~light
        h_id = dense[hm]
        if h_id.shape[0]:
            h_si = sid[hm]
            h_g = qi[hm] // Qd
            key = (h_si * self.dp + h_g) * (nd + 1) + h_id
            uniq_key, inv = np.unique(key, return_inverse=True)
            uk_sg, uk_id = np.divmod(uniq_key, nd + 1)
            grp_first = np.concatenate([[True], uk_sg[1:] != uk_sg[:-1]])
            grp_start = np.where(grp_first, np.arange(uk_sg.shape[0]), 0)
            np.maximum.accumulate(grp_start, out=grp_start)
            u_slot = np.arange(uniq_key.shape[0]) - grp_start
            u_max = int(u_slot.max()) + 1
        else:
            u_max = 0
        hb = self.config.device.heavy_buckets
        U = _pick_shape(max(u_max, 1), hb, self._pin("U", Qb), "U")
        slot_compact = np.full((S, Qb, T), U, np.int32)
        ids = np.full((S, self.dp, Qd * T), nd, np.int32)
        if h_id.shape[0]:
            slot_compact[h_si, qi[hm], slot[hm]] = u_slot[inv]
            uk_s, uk_g = np.divmod(uk_sg, self.dp)
            ids[uk_s, uk_g, u_slot] = uk_id
        plan = np.concatenate(
            [starts, light_dfs, slot_dense, slot_light, slot_compact,
             wbits, ids.reshape(S, Qb, T)],
            axis=2,
        )
        return plan, int(U)

    def _chunk_budget(self, dfs, block) -> int:
        """Static per-device chunk count: max over (shard, dp-group) totals."""
        S, Qb, T = dfs.shape
        DP = self.dp
        Qd = Qb // DP
        reps = (dfs.astype(np.int64) + block - 1) // block
        reps = reps.reshape(S, DP, Qd * T).sum(axis=2)
        total_max = max(int(reps.max(initial=0)), 1)
        return _pick_shape(
            total_max, self.config.device.chunk_buckets,
            self._pin("C", Qb), "C",
        )

    def _light_budget(self, plan_np) -> int:
        """Static live light-pair count L2 for the v4 compact rescore:
        max over (shard, dp-group) of live (query, slot) light pairs
        (DeviceIndex._light_budget per shard_map block)."""
        S, Qb, L = plan_np.shape
        T = L // 7
        live = (plan_np[:, :, 3 * T : 4 * T] < self.n_light) & (
            plan_np[:, :, 5 * T : 6 * T] != 0
        )
        per = live.reshape(S, self.dp, -1).sum(axis=2)
        pairs = int(per.max(initial=0))
        return _pick_shape(
            max(pairs, 1), self.L_BUCKETS, self._pin("L", Qb), "L"
        )

    def _heavy_budget(self, plan_np) -> int:
        """Static live heavy-pair count H2 for the v5 compact rescore:
        max over (shard, dp-group) of live (query, slot) heavy pairs
        (DeviceIndex._heavy_budget per shard_map block)."""
        S, Qb, L = plan_np.shape
        T = L // 7
        live = (plan_np[:, :, 2 * T : 3 * T] < self.n_dense) & (
            plan_np[:, :, 5 * T : 6 * T] != 0
        )
        per = live.reshape(S, self.dp, -1).sum(axis=2)
        pairs = int(per.max(initial=0))
        return _pick_shape(
            max(pairs, 1), self.HP_BUCKETS, self._pin("HP", Qb), "HP"
        )

    def probe_workload(self, batches, shortcut_k: int = 10):
        """Raw (unbucketed) static-shape drivers over a sample workload,
        measured per (shard, dp-group) — the units the shard_map blocks
        compile over. Returns {"T","Q","C","U","L"} like
        DeviceIndex.probe_workload (no "W": the sharded local step keeps
        flat-sort selection). Raw maxima matter: pinning the launch-time
        budgets (which _pick_shape has already bucketed up the ladder)
        pinned C=4096/U=528 where the workload needed 2944/352 — a 39%
        bigger light gather and 50% wider compact row table on every
        batch. The probe applies the 1-term shortcut first, exactly as
        serving does, so C/L budgets exclude host-answered queries'
        postings."""
        block = self.config.device.posting_block
        S, DP = self.n_shards, self.dp
        nd = self.n_dense
        t = q = c = u = li = hp = 1
        for b in batches:
            q = max(q, len(b))
            b, _f = self._shortcut_single_heavy(b, shortcut_k)
            rows, _w, q_lens = _probe_queries_flat(self._lex_slices, b)
            if not rows.shape[0]:
                continue
            qi = np.repeat(np.arange(len(b), dtype=np.int64), q_lens)
            ent = self._lex_table[rows]
            sid = ent[:, 0]
            t = max(t, int(np.bincount(qi * S + sid).max(initial=0)))
            Qb = _round_up(max(len(b), 1), DP)
            if self._pins.get("Q"):
                Qb = _round_up(Qb, self._pins["Q"])
            g = qi // (Qb // DP)
            key_sg = sid * DP + g
            light = ent[:, 3] < 0
            if light.any():
                reps = (ent[light, 2] + block - 1) // block
                c = max(c, int(np.bincount(
                    key_sg[light], weights=reps, minlength=S * DP
                ).max()))
                li = max(li, int(np.bincount(
                    key_sg[light], minlength=S * DP
                ).max()))
            if not light.all():
                hk = key_sg[~light] * (nd + 1) + ent[~light, 3]
                u = max(u, int(np.bincount(
                    np.unique(hk) // (nd + 1), minlength=S * DP
                ).max()))
                hp = max(hp, int(np.bincount(
                    key_sg[~light], minlength=S * DP
                ).max()))
        return {"T": t, "Q": q, "C": c, "U": u, "L": li, "HP": hp}

    def pin_shapes(
        self,
        probe_batches=None,
        *,
        T: Optional[int] = None,
        Q: Optional[int] = None,
        C: Optional[int] = None,
        U: Optional[int] = None,
        L: Optional[int] = None,
        HP: Optional[int] = None,
        c_pad: int = 128,
        u_pad: int = 16,
        scope_q: bool = False,
    ):
        """Freeze batch-varying static kernel shapes (same contract as
        DeviceIndex.pin_shapes; see index/segment.py). Probe sizes are
        measured per (shard, dp-group) — the units the shard_map blocks
        actually compile over. scope_q=True pins {T, C, U, L} for the
        probe's Q envelope only (scoped pins win; see
        DeviceIndex.pin_shapes)."""
        if probe_batches is not None:
            block = self.config.device.posting_block
            sparse = self.config.device.mode == "sparse"
            if sparse:
                m = self.probe_workload(probe_batches)
                t, q, c, u, li = m["T"], m["Q"], m["C"], m["U"], m["L"]
                hp = m["HP"]
            else:
                t = q = c = u = li = hp = 1
                for b in probe_batches:
                    q = max(q, len(b))
                    s, _dfs, _w, light_dfs, uh, _m = self.plan(b)
                    t = max(t, s.shape[2])
                    c = max(c, self._chunk_budget(light_dfs, block))
                    u = max(u, uh.shape[2])
            if scope_q:
                # C/U/L only — T stays on its bounded ladder (see
                # DeviceIndex.pin_shapes on why scoped T pins backfire).
                qb = _round_up(max(q, 1), self.dp)
                if self._pins.get("Q"):
                    qb = _round_up(qb, self._pins["Q"])
                scope = self._qpins.setdefault(qb, {})
                for k, v in (
                    ("C", C or _round_up(c, c_pad)),
                    ("U", U or _round_up(u + 1, u_pad)),
                    ("L", L or _bucket(li, self.L_BUCKETS)),
                    ("HP", HP or _bucket(hp, self.HP_BUCKETS)),
                ):
                    scope[k] = int(v)
                return {qb: dict(scope)}
            T = T or _bucket(t, self.T_BUCKETS)
            Q = Q or _round_up(q, self.dp)
            C = C or _round_up(c, c_pad)
            U = U or _round_up(u + 1, u_pad)
            L = L or _bucket(li, self.L_BUCKETS)
            HP = HP or _bucket(hp, self.HP_BUCKETS)
        elif scope_q:
            raise ValueError("scope_q=True requires probe_batches")
        for k, v in (
            ("T", T), ("Q", Q), ("C", C), ("U", U), ("L", L), ("HP", HP)
        ):
            if v:
                self._pins[k] = int(v)
        return dict(self._pins)

    def _pin(self, key, qb=None):
        """Effective pin for `key`: the Q-scoped pin for this batch's Q
        envelope wins over the global pin; an unwarmed envelope borrows
        the nearest larger warmed one (DeviceIndex._pin contract — see
        its docstring for the measured recompile-flapping failure)."""
        if qb is not None:
            v = self._qpins.get(qb, {}).get(key)
            if v:
                return v
            # borrow only from LARGER warmed envelopes (see DeviceIndex)
            larger = [q for q in self._qpins if q > qb]
            if larger:
                v = self._qpins[min(larger)].get(key)
                if v:
                    return v
        return self._pins.get(key)

    # ---------------- execution ----------------

    def search_batch_async(
        self, queries: Sequence[Sequence[WeightedTerm]], k: int
    ):
        """Launch one sharded batched search; returns an opaque handle.

        Same handle protocol as DeviceIndex.search_batch_async: pair with
        search_batch_gather(), keep several launches in flight to hide the
        host<->device round trip. Transfer-minimal: the whole plan ships as
        ONE int32 device_put (f32 payloads as raw bit patterns); results
        come back in ONE packed f32 device_get.
        """
        import os

        nq = len(queries)
        if nq == 0 or self.n_docs == 0:
            return ("empty", nq)
        K = _bucket(max(k, 1), self.K_BUCKETS)
        K = min(K, self.shard_capacity)
        mode = self.config.device.mode
        block = self.config.device.posting_block
        if mode == "sparse":
            # 1-term head-heavy queries: answered host-side from the
            # per-shard row top-k (exact, canonical, zero guard trips);
            # their batch slots plan as empty queries.
            queries, fills = self._shortcut_single_heavy(queries, k)
            if fills is not None and len(fills) == nq:
                # Whole batch answered host-side (see DeviceIndex:
                # all-shortcut batches skip the device launch).
                return ("fills", nq, k, fills)
            plan_np, U = self.plan_sparse(queries)
            S, Qb, L = plan_np.shape
            T = L // 7
            C = self._chunk_budget(plan_np[:, :, T : 2 * T], block)
            L2 = self._light_budget(plan_np)
            H2 = self._heavy_budget(plan_np)
            K2 = min(
                max(2 * K, self.config.device.rescore_margin),
                self.shard_capacity,
            )
            direct = self._heavy_direct
            fast = (
                self.config.device.fast_heavy
                and direct
                and os.environ.get("NEXTSEARCH_FAST_HEAVY", "1") == "1"
            )
            eps = self.config.device.fast_heavy_eps
            use_compact = (
                os.environ.get("NEXTSEARCH_COMPACT_HEAVY", "1") == "1"
            )
            # Single int32 upload per shard: the 7T single-device plan
            # rows (see plan_sparse).
            plan = jax.device_put(
                plan_np, NamedSharding(self.mesh, P("seg", "dp", None))
            )
            bp = (
                self.bucket_pos
                if self.bucket_pos is not None
                else self._dummy_tables()[0]
            )

            def launch(fh: bool):
                # The exact relaunch (fh=False under fast mode) runs
                # FULL-TABLE, same rule as DeviceIndex: the compact f32
                # gather table is O(U * cap) extra device memory that big
                # envelopes cannot afford next to the dense block.
                uc = use_compact and (fh or not fast)
                key = (
                    K, K2, mode, C, Qb, T, U if uc else 0,
                    self._bs_depth, direct, uc, fh, L2, H2,
                )
                fn = self._fns.get(key)
                if fn is None:
                    fn = _sharded_search_fn(
                        self.mesh, self.shard_capacity, K, block, T,
                        U if uc else 0,
                        mode=mode, K2=K2, C=C, bs_steps=self._bs_depth,
                        nd=self.n_dense, nl=self.n_light,
                        heavy_direct=direct,
                        use_compact=uc, fast_heavy=fh, guard_eps=eps,
                        L2=L2, H2=H2,
                    )
                    self._fns[key] = fn
                out = fn(
                    self.post_doc, self.post_score, self.dense_rows,
                    bp, self.light_bucket_pos, plan,
                )
                out.copy_to_host_async()
                return out

            if fast:
                return (
                    "packedg", nq, k, K, launch(True),
                    lambda: launch(False), None, queries, fills,
                )
            return ("packed", nq, k, K, launch(False), fills)
        starts, dfs, weights, light_dfs, unique_heavy, heavy_mix = self.plan(
            queries
        )
        C = self._chunk_budget(light_dfs if mode != "exact" else dfs, block)
        K2 = min(
            max(2 * K, self.config.device.rescore_margin), self.shard_capacity
        )

        S, Qb, T = starts.shape
        U = unique_heavy.shape[2]
        Qd = Qb // self.dp
        key = (K, K2, mode, C, Qb, T, U)
        fn = self._fns.get(key)
        if fn is None:
            fn = _sharded_search_fn(
                self.mesh, self.shard_capacity, K, block, T, U,
                mode=mode, K2=K2, C=C,
            )
            self._fns[key] = fn

        # Single int32 upload (L = 4T + 2U): starts | dfs | light_dfs |
        # weight bits | heavy-mix bits | unique heavy ids (int32, stored in
        # the first row of each dp group — a shard_map block is exactly one
        # group).
        plan_np = np.zeros((S, Qb, 4 * T + 2 * U), np.int32)
        plan_np[:, :, :T] = starts
        plan_np[:, :, T : 2 * T] = dfs
        plan_np[:, :, 2 * T : 3 * T] = light_dfs
        plan_np[:, :, 3 * T : 4 * T] = weights.view(np.int32)
        if U:
            plan_np[:, :, 4 * T : 4 * T + U] = heavy_mix.reshape(
                S, Qb, U
            ).view(np.int32)
            for g in range(self.dp):
                plan_np[:, g * Qd, 4 * T + U :] = unique_heavy[:, g, :]

        plan = jax.device_put(
            plan_np, NamedSharding(self.mesh, P("seg", "dp", None))
        )
        dummy = self._dummy_tables()
        packed = fn(
            self.post_doc, self.post_score, self.dense_rows,
            dummy[0], dummy[1], plan,
        )
        packed.copy_to_host_async()
        return ("packed", nq, k, K, packed)

    def _dummy_tables(self):
        """Placeholder bucket-table operands for non-sparse modes (the
        local step never touches them)."""
        if getattr(self, "_dummies", None) is None:
            spec = NamedSharding(self.mesh, P("seg", None, None))
            z = np.zeros((self.n_shards, 1, 1), np.int32)
            self._dummies = (
                jax.device_put(z, spec), jax.device_put(z, spec)
            )
        return self._dummies

    def _host_rescue_row(self, out, j, queries, K):
        """Overwrite packed row j with the exact host-oracle result for
        queries[j] (guard-trip rescue; doc slots map through the global
        shard-major layout via segment_slot_bases)."""
        from ..index.oracle import oracle_search_vec

        segs = getattr(self, "_oracle_segs_cache", None)
        if segs is None:
            segs = [s.to_oracle_segment() for s in self.segments]
            self._oracle_segs_cache = segs
        bases = self.segment_slot_bases()
        hits, found = oracle_search_vec(
            segs, queries[j], K,
            k1=self.config.bm25.k1, b=self.config.bm25.b,
        )
        out[j, : 2 * K + 1] = 0.0
        for i, (score, seg_idx, doc) in enumerate(hits[:K]):
            out[j, i] = np.float32(score)
            out[j, K + i] = np.float32(bases[seg_idx] + doc)
        out[j, 2 * K] = np.float32(found)

    def search_batch_gather(self, handle) -> List[QueryResult]:
        """Fetch + unpack the results of a search_batch_async launch."""
        if handle[0] == "empty":
            nq = handle[1]
            return [
                QueryResult(np.empty(0, np.float32), np.empty(0, np.int32), 0)
            ] * nq
        if handle[0] == "fills":
            # whole batch answered host-side by the 1-term shortcut
            _tag, nq, _k, fills = handle
            return [fills[qi] for qi in range(nq)]
        if handle[0] == "packedg":
            # Guarded fast path: same trip protocol as
            # DeviceIndex.search_batch_gather — few trips get the exact
            # host-oracle rescue, many trips one wide HIGHEST relaunch.
            import os as _os

            _tag, nq, k, K, dev_out, relaunch, _perm, queries, fills = (
                handle
            )
            packed = np.asarray(jax.device_get(dev_out))
            tripped = np.flatnonzero(packed[:nq, 2 * K + 1] < 0.5)
            if tripped.size:
                from ..utils.logging import log

                cap = int(_os.environ.get("NEXTSEARCH_TRIP_RESCUE", "8"))
                if queries is not None and tripped.size <= cap:
                    log(
                        "sharded",
                        f"fast-heavy guard tripped ({tripped.size}/{nq} "
                        "queries); host-oracle rescue",
                    )
                    packed = np.array(packed)
                    for j in tripped:
                        self._host_rescue_row(packed, int(j), queries, K)
                else:
                    log(
                        "sharded",
                        f"fast-heavy guard tripped ({tripped.size}/{nq} "
                        "queries); relaunching exact-precision kernel",
                    )
                    packed = np.asarray(jax.device_get(relaunch()))
            k_out = K
            vals = packed[:, :k_out]
            idx = packed[:, k_out : 2 * k_out].astype(np.int32)
            found = packed[:, 2 * k_out]
            out = []
            for qi in range(nq):
                keep = vals[qi] > 0.0
                keep[min(k, k_out):] = False
                out.append(
                    QueryResult(
                        scores=vals[qi][keep][:k],
                        doc_slots=idx[qi][keep][:k],
                        found=int(found[qi]),
                    )
                )
            if fills:
                for qi, qr in fills.items():
                    out[qi] = qr
            return out
        _tag, nq, k, K, packed = handle[:5]
        fills = handle[5] if len(handle) > 5 else None
        packed = jax.device_get(packed)
        k_out = (packed.shape[1] - 1) // 2
        vals = packed[:, :k_out]
        idx = packed[:, k_out : 2 * k_out].astype(np.int32)
        found = packed[:, 2 * k_out]
        out = []
        for qi in range(nq):
            keep = vals[qi] > 0.0
            keep[min(k, k_out):] = False
            out.append(
                QueryResult(
                    scores=vals[qi][keep][:k],
                    doc_slots=idx[qi][keep][:k],
                    found=int(found[qi]),
                )
            )
        if fills:
            for qi, qr in fills.items():
                out[qi] = qr
        return out

    def search_batch(
        self, queries: Sequence[Sequence[WeightedTerm]], k: int
    ) -> List[QueryResult]:
        return self.search_batch_gather(self.search_batch_async(queries, k))

    # ---------------- result mapping ----------------

    def hbm_bytes(self) -> Dict[str, int]:
        """Total device footprint across all shards, bytes by component
        (sharded analog of DeviceIndex.hbm_bytes; arrays here are sharded
        over the mesh, so per-chip usage is total / n_shards for the seg-
        sharded arrays)."""
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
        """Global sharded doc slot -> (segment index, local docId)."""
        si, local = divmod(int(doc_slot), self.shard_capacity)
        lo, _hi = self.shard_seg_ranges[si]
        bases = self.shard_doc_bases[si]
        j = int(np.searchsorted(np.asarray(bases), local, "right") - 1)
        return lo + j, local - bases[j]

    def doc_info(self, doc_slot: int) -> Tuple[str, str, int]:
        seg_idx, doc_id = self.locate(doc_slot)
        return self.seg_names[seg_idx], self.segments[seg_idx].cord_uids[doc_id], doc_id

    def doc_info_batch(self, slots):
        """Vectorized doc_info (render hot path; DeviceIndex contract)."""
        return [self.doc_info(int(s)) for s in np.asarray(slots)]
