"""Sparse-light execution mode (ops/bm25_sparse.py) parity vs oracle.

Covers: light-only queries, heavy-only (dense rows), mixed, multi-segment,
padding rows, duplicate candidates from the light/heavy pools, exact found
counts, and bit-exact scores (unified full-range binary-search rescore),
plus the HTTP server running in sparse mode end to end.
"""

import os

import numpy as np
import pytest

from nextsearch.config import DeviceConfig, EngineConfig
from nextsearch.index.builder import build_segment_arrays
from nextsearch.index.oracle import oracle_search
from nextsearch.index.segment import DeviceIndex

from conftest import make_synthetic_docs


def make_index(segs, dense_ratio=0.02, block=64, unified=True):
    cfg = EngineConfig(
        device=DeviceConfig(
            mode="sparse",
            posting_block=block,
            chunk_buckets=(64, 256, 1024),
            dense_df_ratio=dense_ratio,
            unified=unified,
        )
    )
    return DeviceIndex(segs, config=cfg)


@pytest.fixture(scope="module")
def segs():
    return [
        build_segment_arrays(make_synthetic_docs(80, 220, seed=60)),
        build_segment_arrays(make_synthetic_docs(120, 220, seed=61, avg_len=35)),
        build_segment_arrays(make_synthetic_docs(50, 220, seed=62, avg_len=90)),
    ]


def check_parity(di, segs, queries, k=10):
    oracle_segs = [s.to_oracle_segment() for s in segs]
    results = di.search_batch(queries, k=k)
    for terms, res in zip(queries, results):
        hits, found = oracle_search(oracle_segs, terms, k=k)
        assert res.found == found, (terms, res.found, found)
        assert len(res.scores) == len(hits), (terms, len(res.scores), len(hits))
        for (o_s, o_seg, o_doc), d_s, d_slot in zip(
            hits, res.scores, res.doc_slots
        ):
            assert di.locate(int(d_slot)) == (o_seg, o_doc), terms
            assert np.float32(d_s) == np.float32(o_s), (terms, d_s, o_s)


def test_sparse_matches_oracle_mixed(segs):
    di = make_index(segs)
    assert di.n_dense > 0  # heavy path exercised
    queries = [
        [("w0000", 1.0)],                      # heaviest term
        [("w0150", 1.0)],                      # light term
        [("w0001", 1.0), ("w0180", 0.7)],      # heavy + light
        [("w0002", 0.9), ("w0003", 0.8), ("w0160", 0.5)],
        [("nosuchterm", 1.0)],
        [("w0005", 1.0), ("w0005", 0.5)],      # duplicate term
        [("w0199", 1.2)],
    ]
    check_parity(di, segs, queries)


def test_sparse_light_only(segs):
    """dense_df_ratio=0 -> everything goes through the sort/segsum path."""
    di = make_index(segs, dense_ratio=0.0)
    assert di.n_dense == 0
    queries = [
        [("w0000", 1.0), ("w0001", 0.6)],
        [("w0100", 1.0)],
        [("w0010", 0.4), ("w0020", 1.1), ("w0030", 0.9), ("w0040", 0.2)],
    ]
    check_parity(di, segs, queries)


def test_sparse_heavy_only():
    """All terms dense -> pure fused-matmul candidates."""
    docs = make_synthetic_docs(150, 30, seed=63)  # tiny vocab -> all heavy
    seg = build_segment_arrays(docs)
    di = make_index([seg], dense_ratio=0.001)
    assert di.n_dense == len([d for d in seg.term_df if d > 0])
    queries = [
        [("w0000", 1.0)],
        [("w0001", 0.8), ("w0002", 0.5)],
        [("w0029", 1.0), ("w0000", 0.3)],
    ]
    check_parity(di, [seg], queries)


@pytest.mark.parametrize("eps", [2e-3, 1e9])
def test_sparse_fast_heavy_guard(segs, eps):
    """The guarded fast path (DEFAULT matmul + merged K2 pool) must stay
    bit-exact: with the default eps the guard mostly passes (CPU dots are
    exact); with eps=1e9 the guard trips on every non-trivial query and
    every batch goes through the relaunch path — both must match the
    oracle exactly."""
    cfg = EngineConfig(
        device=DeviceConfig(
            mode="sparse", posting_block=64, chunk_buckets=(64, 256, 1024),
            dense_df_ratio=0.02, fast_heavy=True, fast_heavy_eps=eps,
        )
    )
    di = DeviceIndex(segs, config=cfg)
    r = np.random.default_rng(43)
    words = [f"w{i:04d}" for i in range(220)]
    queries = [
        [(words[int(r.integers(0, 220))], float(r.uniform(0.2, 1.5)))
         for _ in range(int(r.integers(1, 5)))]
        for _ in range(24)
    ]
    check_parity(di, segs, queries)


def test_sparse_multi_launch_parity(segs):
    """A batch above launch_group runs G block-diagonal sub-batches in one
    device launch (bm25_search_sparse_packed_multi); results must be
    bit-identical to the oracle and to per-group single launches, with the
    last group padded."""
    cfg = EngineConfig(
        device=DeviceConfig(
            mode="sparse", posting_block=64, chunk_buckets=(64, 256, 1024),
            dense_df_ratio=0.02, launch_group=8,
        )
    )
    di = DeviceIndex(segs, config=cfg)
    r = np.random.default_rng(99)
    words = [f"w{i:04d}" for i in range(220)]
    queries = []
    for _ in range(19):  # 3 groups of 8, last partial
        nt = int(r.integers(1, 5))
        queries.append(
            [(words[int(r.integers(0, 220))], float(r.uniform(0.2, 1.5)))
             for _ in range(nt)]
        )
    check_parity(di, segs, queries)
    multi = di.search_batch(queries, k=10)
    singles = []
    for gi in range(0, len(queries), 8):
        singles.extend(di.search_batch(queries[gi:gi + 8], k=10))
    for a, b in zip(multi, singles):
        assert a.found == b.found
        assert np.array_equal(a.scores, b.scores)
        assert np.array_equal(a.doc_slots, b.doc_slots)


@pytest.mark.parametrize("unified", [True, False])
def test_sparse_bf16_rows_exact_scores(segs, unified):
    """The bf16 dense-rows opt-in keeps the v2 bucket-table rescore (bf16
    row values are NOT the exact eager scores, so heavy slots must binary-
    search postings): reported scores stay bit-exact vs the oracle."""
    cfg = EngineConfig(
        device=DeviceConfig(
            mode="sparse", posting_block=64, chunk_buckets=(64, 256, 1024),
            dense_df_ratio=0.02, unified=unified, dense_rows_bf16=True,
        )
    )
    di = DeviceIndex(segs, config=cfg)
    assert di.n_dense > 0 and not di._heavy_direct
    assert di.bucket_pos is not None
    check_parity(di, segs, [
        [("w0000", 1.0)],
        [("w0001", 1.0), ("w0180", 0.7)],
        [("w0002", 0.9), ("w0003", 0.8), ("w0160", 0.5)],
    ])


@pytest.mark.parametrize("unified", [True, False])
def test_sparse_fuzz(segs, unified):
    di = make_index(segs, unified=unified)
    r = np.random.default_rng(64)
    words = [f"w{i:04d}" for i in range(220)]
    queries = []
    for _ in range(60):
        nt = int(r.integers(1, 5))
        queries.append(
            [
                (words[int(r.integers(0, 220))], float(r.uniform(0.2, 1.5)))
                for _ in range(nt)
            ]
        )
    check_parity(di, segs, queries)


@pytest.mark.parametrize("unified", [True, False])
def test_sparse_unified_vs_packed_parity(segs, unified):
    """The unified-totals pipeline and the split light/heavy packed kernel
    must both match the oracle on the same mixed query set (unified is the
    serving default; packed is the fallback)."""
    di = make_index(segs, unified=unified)
    check_parity(di, segs, [
        [("w0000", 1.0)],
        [("w0000", 1.0), ("w0150", 0.7)],
        [("w0001", 0.5), ("w0002", 1.0), ("w0190", 0.9)],
        [("w0150", 1.0), ("w0180", 0.4)],   # light-only multi-term
        [("nosuchterm", 1.0)],
    ])


def test_server_sparse_mode_end_to_end(tmp_path):
    """/api/search served by a sparse-mode engine matches the fused engine
    byte-for-byte on scores/found (the --mode server flag's engine path)."""
    import json as _json
    import http.client
    import threading

    from nextsearch.api.ai import AzureOpenAIConfig
    from nextsearch.api.feedback import FeedbackManager
    from nextsearch.api.server import ServerContext, make_server
    from nextsearch.api.stats import StatsTracker
    from nextsearch.engine import Engine
    from nextsearch.index.segmentio import save_manifest, write_segment

    d = tmp_path / "index"
    (d / "segments").mkdir(parents=True)
    write_segment(
        build_segment_arrays(make_synthetic_docs(120, 80, seed=77)),
        d / "segments" / "seg_000001",
    )
    save_manifest(d / "manifest.bin", ["seg_000001"])

    def serve(mode, subdir):
        cfg = EngineConfig(device=DeviceConfig(mode=mode))
        cache = tmp_path / subdir
        cache.mkdir()
        eng = Engine(d, config=cfg, cache_dir=cache)
        assert eng.reload()
        ctx = ServerContext(
            eng,
            StatsTracker(cache / "stats.json"),
            FeedbackManager(cache / "feedback.json"),
            AzureOpenAIConfig("", "", ""),
        )
        srv = make_server(ctx, host="127.0.0.1", port=0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        return srv, ctx

    def get(srv, path):
        conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1])
        conn.request("GET", path)
        r = conn.getresponse()
        body = r.read()
        conn.close()
        return r.status, _json.loads(body)

    s_sparse, c_sparse = serve("sparse", "sparse")
    s_fused, c_fused = serve("fused", "fused")
    try:
        words = [f"w{i:04d}" for i in range(0, 80, 7)]
        for w in words[:6]:
            q = f"/api/search?q={w}+{words[-1]}&k=5"
            st1, r1 = get(s_sparse, q)
            st2, r2 = get(s_fused, q)
            assert st1 == st2 == 200
            assert r1["found"] == r2["found"] > 0
            assert r1["results"], q  # non-trivial: queries must hit docs
            assert [x["score"] for x in r1["results"]] == [
                x["score"] for x in r2["results"]
            ]
            assert [x["cord_uid"] for x in r1["results"]] == [
                x["cord_uid"] for x in r2["results"]
            ]
    finally:
        s_sparse.shutdown()
        c_sparse.batcher.shutdown()
        s_fused.shutdown()
        c_fused.batcher.shutdown()


def test_device_build_matches_host_build(segs, monkeypatch):
    """index/device_build.py must reproduce the host-built dense rows and
    bucket tables bit-for-bit (same scores, same offsets, same depth)."""
    monkeypatch.setenv("NEXTSEARCH_DEVICE_BUILD", "0")
    host = make_index(segs)
    monkeypatch.setenv("NEXTSEARCH_DEVICE_BUILD", "1")
    # force the device light-table scatter (the default builds the light
    # table host-side and uploads it, which would leave
    # build_light_on_device untested here)
    monkeypatch.setenv("NEXTSEARCH_LIGHT_BUILD", "device")
    dev = make_index(segs)
    assert dev._device_build and not host._device_build
    hrows = np.asarray(host.dense_rows, np.float32)
    drows = np.asarray(dev.dense_rows, np.float32)
    # device build may round the row count up to its group grid; the extra
    # rows must be zero (the heavy kernel sizes mix from dense.shape[0])
    assert drows.shape[0] >= hrows.shape[0]
    assert np.array_equal(hrows, drows[: hrows.shape[0]])
    assert not drows[hrows.shape[0]:].any()
    # f32 rows rescore heavy slots straight off the dense table: neither
    # build produces a heavy bucket table (heavy-direct rescore)
    assert host.bucket_pos is None and dev.bucket_pos is None
    assert np.array_equal(
        np.asarray(host.light_bucket_pos), np.asarray(dev.light_bucket_pos)
    )
    assert host._bs_depth == dev._bs_depth
    assert host.n_light == dev.n_light


def test_sparse_compact_heavy_matches(segs, monkeypatch):
    """The compact heavy path (use_compact) must match the full-table path
    bit for bit (CPU exercises the XLA-gather fallback)."""
    monkeypatch.setenv("NEXTSEARCH_COMPACT_HEAVY", "1")
    di = make_index(segs)
    check_parity(di, segs, [
        [("w0000", 1.0)],
        [("w0000", 1.0), ("w0150", 0.7)],
        [("w0001", 0.5), ("w0002", 1.0), ("w0190", 0.9)],
        [("w0199", 1.0)],
    ])


def test_near_uniform_heavy_term_exact():
    """A df=N term whose per-doc scores differ only in the 4th significant
    digit: bf16 dense rows (or quantized selection keys) collapse these
    into false ties and the K2 candidate pool drops true top-K docs.
    Regression for the selection-exactness hole found at 25k docs."""
    r = np.random.default_rng(51)
    n_docs = 4096
    docs = []
    for i in range(n_docs):
        # one omnipresent term; doc lengths vary slightly -> near-uniform
        # but DISTINCT scores
        filler = [f"f{j:05d}" for j in r.integers(0, 50_000, size=int(r.integers(18, 24)))]
        docs.append({"cord_uid": f"d{i}", "tokens": ["common"] + filler})
    seg = build_segment_arrays(docs)
    cfg = EngineConfig(
        device=DeviceConfig(
            mode="sparse", posting_block=256, chunk_buckets=(64, 4096),
            dense_df_ratio=0.001,
            # keep this on the KERNEL path: the row-topk shortcut would
            # answer a 1-term heavy query host-side and skip the very
            # selection code this regression exists to test
            row_topk_rows=0,
        )
    )
    di = DeviceIndex([seg], config=cfg)
    assert di.lex[0]["common"][2] >= 0  # dense row engaged
    assert di._row_topk is None
    check_parity(di, [seg], [[("common", 1.0)]])


def test_query_window_ordering_parity(segs, monkeypatch):
    """The optional window-size query ordering must be invisible: results come back in the caller's original query order,
    bit-identical to the unordered path."""
    monkeypatch.setenv("NEXTSEARCH_SORT_QUERIES", "1")
    cfg = EngineConfig(
        device=DeviceConfig(
            mode="sparse", posting_block=64, chunk_buckets=(64, 256, 1024),
            dense_df_ratio=0.02,
        )
    )
    di = DeviceIndex(segs, config=cfg)
    # repeated multi-term queries over the biggest light terms
    r = np.random.default_rng(17)
    words = [f"w{i:04d}" for i in range(220)]
    queries = [
        [(words[int(r.integers(0, 220))], float(r.uniform(0.2, 1.5)))
         for _ in range(int(r.integers(1, 6)))]
        for _ in range(24)
    ]
    wins = di._query_windows(queries)
    res_sorted = di.search_batch(queries, k=10)
    monkeypatch.delenv("NEXTSEARCH_SORT_QUERIES")
    res_plain = di.search_batch(queries, k=10)
    assert len(res_sorted) == len(res_plain)
    for a, b in zip(res_sorted, res_plain):
        assert np.array_equal(a.scores, b.scores)
        assert np.array_equal(a.doc_slots, b.doc_slots)
        assert a.found == b.found
    # and against the oracle
    check_parity(di, segs, queries)


def test_guard_trip_host_rescue(segs, monkeypatch):
    """With the rescue cap raised, every tripped query is re-scored by the
    vectorized host oracle instead of the wide device relaunch — results
    must stay bit-exact (eps=1e9 forces every query to trip)."""
    monkeypatch.setenv("NEXTSEARCH_TRIP_RESCUE", "100")
    cfg = EngineConfig(
        device=DeviceConfig(
            mode="sparse", posting_block=64, chunk_buckets=(64, 256, 1024),
            dense_df_ratio=0.02, fast_heavy=True, fast_heavy_eps=1e9,
        )
    )
    di = DeviceIndex(segs, config=cfg)
    r = np.random.default_rng(47)
    words = [f"w{i:04d}" for i in range(220)]
    queries = [
        [(words[int(r.integers(0, 220))], float(r.uniform(0.2, 1.5)))
         for _ in range(int(r.integers(1, 5)))]
        for _ in range(24)
    ]
    check_parity(di, segs, queries)


def test_sparse_fulltable_mode_parity(segs, monkeypatch):
    """use_compact off (the exact-relaunch configuration) must stay
    oracle-exact end to end through the 3D full-table kernel path."""
    monkeypatch.setenv("NEXTSEARCH_COMPACT_HEAVY", "0")
    cfg = EngineConfig(
        device=DeviceConfig(
            mode="sparse", posting_block=64, chunk_buckets=(64, 256, 1024),
            dense_df_ratio=0.02,
        )
    )
    di = DeviceIndex(segs, config=cfg)
    r = np.random.default_rng(48)
    words = [f"w{i:04d}" for i in range(220)]
    queries = [
        [(words[int(r.integers(0, 220))], float(r.uniform(0.2, 1.5)))
         for _ in range(int(r.integers(1, 5)))]
        for _ in range(16)
    ]
    check_parity(di, segs, queries)


def test_adaptive_light_buckets_parity(segs, monkeypatch):
    """A tiny light-table budget forces coarser bucket granularity
    (lb_log2 > default); the rescore must stay oracle-exact through the
    coarser binary search (deeper bs via measured occupancy)."""
    from nextsearch.ops.bm25_sparse import LIGHT_BUCKET_LOG2

    monkeypatch.setenv("NEXTSEARCH_LIGHT_TABLE_BYTES", "2048")
    cfg = EngineConfig(
        device=DeviceConfig(
            mode="sparse", posting_block=64, chunk_buckets=(64, 256, 1024),
            dense_df_ratio=0.02,
        )
    )
    di = DeviceIndex(segs, config=cfg)
    assert di._lb_log2 > LIGHT_BUCKET_LOG2
    r = np.random.default_rng(49)
    words = [f"w{i:04d}" for i in range(220)]
    queries = [
        [(words[int(r.integers(0, 220))], float(r.uniform(0.2, 1.5)))
         for _ in range(int(r.integers(1, 5)))]
        for _ in range(16)
    ]
    check_parity(di, segs, queries)


def test_merged_heavy_rows_multi_segment(segs):
    """Multi-segment sparse mode merges each heavy term's per-segment
    postings into ONE global dense row (classification by GLOBAL df):
    one planning slot and one matmul row per heavy term, not per
    (term, segment) — the EVAL config-3 fix. Bit-exact because a doc
    lives in exactly one segment and the other segments contribute
    literal +0.0f at its slot."""
    di = make_index(segs, dense_ratio=0.02, unified=False)
    assert di._merged_heavy
    # global classification: n_dense counts TERMS, every segment of a
    # heavy term shares its row id
    heavy_terms = {
        t for lex in di.lex for t, v in lex.items() if v[2] >= 0
    }
    assert di.n_dense == len(heavy_terms) > 0
    for t in heavy_terms:
        rows = {lex[t][2] for lex in di.lex if t in lex and lex[t][1] > 0}
        assert len(rows) == 1
        # ONE planning slot for the term (the merged table row)
        off, cnt = di._lex_slices[t]
        assert cnt == 1
        assert di._lex_table[off, 1] == sum(
            lex[t][1] for lex in di.lex if t in lex
        )

    # a term heavy GLOBALLY but light per segment must be dense
    per_seg_max = max(
        max((lex[t][1] for lex in di.lex if t in lex), default=0)
        for t in heavy_terms
    )
    straddlers = [
        t for t in heavy_terms
        if all(
            lex[t][1] < di.dense_threshold for lex in di.lex if t in lex
        )
    ]
    assert straddlers, (
        "fixture lost its straddling terms (per-seg df < threshold <= "
        f"global df); per-seg max {per_seg_max}"
    )

    r = np.random.default_rng(51)
    words = [f"w{i:04d}" for i in range(220)]
    queries = [[(t, 1.0)] for t in list(straddlers)[:4]] + [
        [(words[int(r.integers(0, 220))], float(r.uniform(0.2, 1.5)))
         for _ in range(int(r.integers(1, 5)))]
        for _ in range(16)
    ]
    check_parity(di, segs, queries)


def test_merged_heavy_device_build_matches_host(segs, monkeypatch):
    """Merged (many-to-one) dense-row scatter: device finalization must
    equal the host scatter bit-for-bit."""
    import jax.numpy as jnp

    monkeypatch.setenv("NEXTSEARCH_DEVICE_BUILD", "1")
    monkeypatch.setenv("NEXTSEARCH_LIGHT_BUILD", "device")
    di_dev = make_index(segs, dense_ratio=0.02, unified=False)
    monkeypatch.setenv("NEXTSEARCH_DEVICE_BUILD", "0")
    di_host = make_index(segs, dense_ratio=0.02, unified=False)
    assert di_dev._merged_heavy and di_host._merged_heavy
    assert di_dev.n_dense == di_host.n_dense
    nd = di_dev.n_dense
    a = np.asarray(di_dev.dense_rows[: nd + 1], np.float32)
    b = np.asarray(di_host.dense_rows[: nd + 1], np.float32)
    assert (a == b).all()
    assert np.asarray(
        jnp.equal(
            di_dev.light_bucket_pos, di_host.light_bucket_pos
        ).all()
    )


def test_row_topk_shortcut_parity(segs):
    """1-term head-heavy queries answered from the precomputed row-topk
    must be oracle-exact (scores, canonical order, found=global df), and
    the shortcut must NOT fire for duplicate-term or multi-term queries
    (their accumulation order differs)."""
    di = make_index(segs, dense_ratio=0.02, unified=False)
    assert di._row_topk is not None
    heavy_terms = sorted(
        {t for lex in di.lex for t, v in lex.items() if v[2] >= 0}
    )
    assert heavy_terms
    t0 = heavy_terms[0]

    # shortcut engages for 1-term heavy queries (weight 1 and weight != 1)
    q, fills = di._shortcut_single_heavy([[(t0, 1.0)], [(t0, 0.7)]], 10)
    assert fills is not None and 0 in fills
    assert q[0] == []

    queries = [[(t, 1.0)] for t in heavy_terms[:6]]
    queries += [[(t0, 0.7)], [(t0, 2.5)]]
    check_parity(di, segs, queries)

    # duplicate-term and multi-term queries keep the kernel path
    q2, fills2 = di._shortcut_single_heavy(
        [[(t0, 1.0), (t0, 0.5)], [(t0, 1.0), (heavy_terms[1], 1.0)]], 10
    )
    assert fills2 is None
    check_parity(di, segs, [[(t0, 1.0), (t0, 0.5)]])


def test_row_topk_shortcut_in_batch(segs):
    """Shortcut queries inside a mixed batch (with the window-size query
    permutation active) land at their ORIGINAL batch positions."""
    import os

    di = make_index(segs, dense_ratio=0.02, unified=False)
    heavy_terms = sorted(
        {t for lex in di.lex for t, v in lex.items() if v[2] >= 0}
    )
    t0 = heavy_terms[0]
    os.environ["NEXTSEARCH_SORT_QUERIES"] = "1"
    try:
        queries = [
            [("w0150", 1.0), ("w0180", 0.7)],
            [(t0, 1.0)],
            [("w0160", 1.0)],
            [(t0, 0.9)],
            [("w0001", 1.0), ("w0170", 0.4)],
        ]
        check_parity(di, segs, queries)
    finally:
        del os.environ["NEXTSEARCH_SORT_QUERIES"]


def test_all_shortcut_batch_skips_launch(segs):
    """A batch in which EVERY query is answered by the 1-term shortcut
    must not launch a device kernel at all (handle tag 'fills') and the
    gathered results must stay oracle-exact at their original batch
    positions — single-term Zipf streams over a head-heavy vocabulary
    (BASELINE config 1) are all-shortcut in steady state."""
    di = make_index(segs, dense_ratio=0.02, unified=False)
    heavy_terms = sorted(
        {t for lex in di.lex for t, v in lex.items() if v[2] >= 0}
    )
    assert len(heavy_terms) >= 3
    queries = [[(t, 1.0)] for t in heavy_terms[:3]]
    queries.append([(heavy_terms[0], 1.0)])  # memoized repeat
    handle = di.search_batch_async(queries, 10)
    assert handle[0] == "fills"
    res = di.search_batch_gather(handle)
    assert len(res) == len(queries)
    check_parity(di, segs, queries)

    # one kernel-path query in the batch keeps the launch path
    mixed = queries + [[("w0150", 1.0), ("w0180", 0.7)]]
    handle2 = di.search_batch_async(mixed, 10)
    assert handle2[0] != "fills"
    di.search_batch_gather(handle2)
    check_parity(di, segs, mixed)


def test_light_topk_shortcut_parity(segs):
    """1-term LIGHT queries answered host-side from the per-(term,
    segment) posting top-k must be oracle-exact: single- and multi-
    segment terms (per-segment prefixes merged by (score desc, global
    slot asc)), w != 1 (re-sort + incomplete-prefix boundary rule),
    df above and below the prefix width, and found = summed dfs.
    Duplicate-term, multi-term, and k > light_topk_k requests keep the
    kernel path."""
    di = make_index(segs, dense_ratio=0.02, unified=False)
    assert di._light_topk is not None
    kl = di._light_topk[0].shape[1]

    # light terms by segment-occurrence count
    occ = {}
    for lex in di.lex:
        for t, v in lex.items():
            if v[1] > 0 and v[2] < 0:
                occ[t] = occ.get(t, 0) + 1
    multi = sorted(t for t, n in occ.items() if n >= 2)
    single = sorted(t for t, n in occ.items() if n == 1)
    assert multi and single, "fixture must produce both occurrence shapes"
    big = sorted(
        (t for t in occ
         if max(lex[t][1] for lex in di.lex if t in lex) > kl),
        key=lambda t: -max(lex[t][1] for lex in di.lex if t in lex),
    )

    q, fills = di._shortcut_single_heavy([[(multi[0], 1.0)]], 10)
    assert fills is not None and q[0] == []
    # k above the stored prefix -> kernel path
    q2, fills2 = di._shortcut_single_heavy([[(multi[0], 1.0)]], kl + 1)
    assert fills2 is None
    # duplicate-term -> kernel path
    q3, fills3 = di._shortcut_single_heavy(
        [[(multi[0], 1.0), (multi[0], 0.5)]], 10
    )
    assert fills3 is None

    queries = (
        [[(t, 1.0)] for t in multi[:3] + single[:3]]
        + [[(multi[0], 0.7)], [(single[0], 2.5)], [(multi[0], 1.0), ("w0002", 0.6)]]
        + ([[(big[0], 1.0)], [(big[0], 0.9)]] if big else [])
    )
    check_parity(di, segs, queries)


def test_probe_workload_applies_shortcut(segs):
    """pin_shapes' workload probe must exclude shortcut-eligible 1-term
    queries, so the pinned C budget shrinks below the raw plan's."""
    di = make_index(segs, dense_ratio=0.02, unified=False)
    light = sorted(
        t for lex in di.lex for t, v in lex.items()
        if v[1] > 0 and v[2] < 0
    )
    batch = [[(t, 1.0)] for t in light[:24]]
    m = di.probe_workload([batch])
    # every query is shortcut-eligible -> nothing reaches the kernel plan
    assert m["C"] == 1 and m["L"] == 1
    raw = di._chunk_budget(
        di.plan_full(batch)[3], di.config.device.posting_block
    )
    assert raw > 1


@pytest.mark.parametrize("eps", [2e-3, 1e9])
def test_unified_fast_heavy_guard(segs, eps):
    """The GUARDED fast unified pipeline (DEFAULT heavy dot folded with
    exact in-kernel light entries, single K2 pool, guard column) must stay
    bit-exact: with the default eps the guard mostly passes (CPU dots are
    exact); with eps=1e9 every non-trivial query trips and relaunches the
    exact wide PACKED kernel — both must match the oracle exactly."""
    cfg = EngineConfig(
        device=DeviceConfig(
            mode="sparse", posting_block=64, chunk_buckets=(64, 256, 1024),
            dense_df_ratio=0.02, unified=True,
            fast_heavy=True, fast_heavy_eps=eps,
        )
    )
    di = DeviceIndex(segs, config=cfg)
    assert di.n_dense > 0
    r = np.random.default_rng(53)
    words = [f"w{i:04d}" for i in range(220)]
    queries = [
        [(words[int(r.integers(0, 220))], float(r.uniform(0.2, 1.5)))
         for _ in range(int(r.integers(1, 5)))]
        for _ in range(24)
    ]
    check_parity(di, segs, queries)


def test_unified_fast_guard_trip_host_rescue(segs, monkeypatch):
    """Unified fast trips with the rescue cap raised go through the
    vectorized host oracle (eps=1e9 forces every query to trip)."""
    monkeypatch.setenv("NEXTSEARCH_TRIP_RESCUE", "100")
    cfg = EngineConfig(
        device=DeviceConfig(
            mode="sparse", posting_block=64, chunk_buckets=(64, 256, 1024),
            dense_df_ratio=0.02, unified=True,
            fast_heavy=True, fast_heavy_eps=1e9,
        )
    )
    di = DeviceIndex(segs, config=cfg)
    r = np.random.default_rng(59)
    words = [f"w{i:04d}" for i in range(220)]
    queries = [
        [(words[int(r.integers(0, 220))], float(r.uniform(0.2, 1.5)))
         for _ in range(int(r.integers(1, 5)))]
        for _ in range(24)
    ]
    check_parity(di, segs, queries)


def test_deal_sorted_balances_groups():
    """Dealing a window-sorted order round-robin keeps each group block
    internally sorted and balances window mass across groups (a plain
    sort concentrates the big windows in the LAST group, whose inflated
    C/L2 budgets tax every group — all share one kernel shape)."""
    from nextsearch.index.segment import _deal_sorted

    r = np.random.default_rng(7)
    for nq, g in [(16, 4), (19, 8), (1024, 512), (33, 32), (9, 4)]:
        wins = r.integers(0, 1 << 20, size=nq)
        order = np.argsort(wins, kind="stable")
        perm = _deal_sorted(order, g)
        # a permutation
        assert sorted(perm.tolist()) == list(range(nq))
        gn = -(-nq // g)
        sizes = [g] * (gn - 1) + [nq - g * (gn - 1)]
        off = 0
        for sz in sizes:
            blk = perm[off : off + sz]
            w = wins[blk]
            # each group block is internally sorted by window size
            assert (np.diff(w) >= 0).all(), (nq, g)
            # window mass balanced proportionally to group size, within
            # a couple of max-element slack (ragged last group fills
            # early, shifting its share onto the full groups)
            if gn > 1:
                bound = wins.sum() * sz / nq + 2 * wins.max()
                assert w.sum() <= bound, (nq, g, sz, int(w.sum()), bound)
            off += sz


def test_deal_sorted_group_parity(segs):
    """Window-sorted + dealt grouping stays oracle-exact on a skewed
    batch (big-window queries interleaved with tiny ones)."""
    cfg = EngineConfig(
        device=DeviceConfig(
            mode="sparse", posting_block=64, chunk_buckets=(64, 256, 1024),
            dense_df_ratio=0.02, launch_group=8,
        )
    )
    di = DeviceIndex(segs, config=cfg)
    os.environ["NEXTSEARCH_SORT_QUERIES"] = "1"
    try:
        r = np.random.default_rng(61)
        words = [f"w{i:04d}" for i in range(220)]
        # skew: half the queries repeat the highest-df terms (big light
        # windows), half are single rare terms
        queries = []
        for i in range(21):
            if i % 2 == 0:
                queries.append(
                    [(words[int(r.integers(0, 8))], 1.0),
                     (words[int(r.integers(0, 8))], 0.7)]
                )
            else:
                queries.append([(words[int(r.integers(100, 220))], 1.0)])
        check_parity(di, segs, queries)
    finally:
        os.environ.pop("NEXTSEARCH_SORT_QUERIES", None)


def test_segmented_cumsum_bounded_serial_order():
    """The bounded fold matches serial left-fold accumulation exactly for
    every segment length <= tmax (live groups never exceed T: at most one
    lane per term slot per doc)."""
    import jax.numpy as jnp

    from nextsearch.ops.bm25_sparse import _segmented_cumsum_bounded

    rng = np.random.default_rng(7)
    for tmax in (1, 2, 4, 7):
        lens, total = [], 0
        while total < 300:
            n = int(rng.integers(1, tmax + 1))
            lens.append(n)
            total += n
        vals = rng.uniform(0.1, 3.0, total).astype(np.float32)
        first = np.zeros(total, bool)
        pos = 0
        for n in lens:
            first[pos] = True
            pos += n
        out = np.asarray(
            _segmented_cumsum_bounded(
                jnp.asarray(vals), jnp.asarray(first), tmax
            )
        )
        # serial reference: f32 left fold restarting at each boundary
        ref = np.empty_like(vals)
        acc = np.float32(0.0)
        for i in range(total):
            acc = vals[i] if first[i] else np.float32(acc + vals[i])
            ref[i] = acc
        assert out.tolist() == ref.tolist()


def test_segmented_cumsum_bounded_overlong_tail_masked():
    """Lanes deeper than tmax into a segment (the sentinel padding group)
    return the tmax-lane fold — callers mask them; boundary lanes of LIVE
    segments are unaffected."""
    import jax.numpy as jnp

    from nextsearch.ops.bm25_sparse import _segmented_cumsum_bounded

    vals = jnp.asarray(np.ones(10, np.float32))
    first = np.zeros(10, bool)
    first[0] = True  # one 10-long segment, tmax=4
    out = np.asarray(
        _segmented_cumsum_bounded(jnp.asarray(vals), jnp.asarray(first), 4)
    )
    assert out[:4].tolist() == [1.0, 2.0, 3.0, 4.0]
    assert (out[4:] == 4.0).all()  # truncated fold, masked by callers


def test_cumsum_count_blocked_matches():
    import jax.numpy as jnp

    from nextsearch.ops.bm25_sparse import _cumsum_count_blocked

    rng = np.random.default_rng(11)
    for n in (64, 1024, 4096, 128 * 37, 1000):  # incl. non-multiple fallback
        ind = rng.integers(0, 2, n).astype(bool)
        out = np.asarray(_cumsum_count_blocked(jnp.asarray(ind)))
        assert out.tolist() == np.cumsum(ind.astype(np.int32)).tolist()


def test_rescue_memo_answers_repeat_trippers(segs, monkeypatch):
    """A guard-tripped query's host-oracle rescue is memoized by (terms,
    K): when the same query recurs it answers at plan time with zero
    device work and no second rescue (the tools-built corpus trips on
    the SAME 2-term df~N query every time it cycles; each oracle pass
    costs 40-50 ms there)."""
    monkeypatch.setenv("NEXTSEARCH_TRIP_RESCUE", "100")
    cfg = EngineConfig(
        device=DeviceConfig(
            mode="sparse", posting_block=64, chunk_buckets=(64, 256, 1024),
            dense_df_ratio=0.02, fast_heavy=True, fast_heavy_eps=1e9,
        )
    )
    di = DeviceIndex(segs, config=cfg)
    r = np.random.default_rng(17)
    words = [f"w{i:04d}" for i in range(220)]
    queries = [
        [(words[int(r.integers(0, 220))], float(r.uniform(0.2, 1.5)))
         for _ in range(int(r.integers(1, 4)))]
        for _ in range(12)
    ]
    first = di.search_batch(queries, k=10)
    trips_after_first = di.rescue_trips
    assert trips_after_first > 0  # eps=1e9 trips every non-trivial query
    assert di._rescue_memo
    second = di.search_batch(queries, k=10)
    assert di.rescue_trips == trips_after_first  # no re-rescue
    for a, b in zip(first, second):
        assert a.found == b.found
        assert np.array_equal(a.scores, b.scores)
        assert np.array_equal(a.doc_slots, b.doc_slots)
    check_parity(di, segs, queries)
