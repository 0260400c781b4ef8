"""Sharded (dp, seg) mesh search parity vs oracle and single-device engine."""

import numpy as np
import pytest

import jax

from nextsearch.index.builder import build_segment_arrays
from nextsearch.index.oracle import oracle_search
from nextsearch.index.segment import DeviceIndex
from nextsearch.parallel.mesh import make_mesh
from nextsearch.parallel.sharded import ShardedIndex

from conftest import make_synthetic_docs

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


@pytest.fixture(scope="module")
def segs():
    return [
        build_segment_arrays(make_synthetic_docs(60, 200, seed=10)),
        build_segment_arrays(make_synthetic_docs(90, 200, seed=11, avg_len=40)),
        build_segment_arrays(make_synthetic_docs(40, 200, seed=12, avg_len=80)),
        build_segment_arrays(make_synthetic_docs(75, 200, seed=13)),
        build_segment_arrays(make_synthetic_docs(25, 200, seed=14)),
    ]


QUERIES = [
    [("w0000", 1.0)],
    [("w0001", 1.0), ("w0005", 1.0)],
    [("w0002", 1.0), ("w0013", 0.42), ("w0190", 0.6)],
    [("nosuchterm", 1.0)],
    [("w0199", 1.0)],
    [("w0003", 0.9), ("w0004", 0.8)],
]


@pytest.mark.parametrize(
    "dp,seg,mode",
    [
        (1, 8, "fused"), (2, 4, "fused"), (4, 2, "fused"), (2, 4, "exact"),
        (1, 8, "sparse"), (2, 4, "sparse"), (4, 2, "sparse"),
    ],
)
def test_sharded_matches_oracle(segs, dp, seg, mode):
    from nextsearch.config import DeviceConfig, EngineConfig

    cfg = EngineConfig(
        device=DeviceConfig(mode=mode, posting_block=64, chunk_buckets=(64, 256))
    )
    mesh = make_mesh(dp=dp, seg=seg)
    si = ShardedIndex(segs, mesh, config=cfg)
    # shard ranges must partition [0, n_segs)
    covered = []
    for lo, hi in si.shard_seg_ranges:
        covered.extend(range(lo, hi))
    assert covered == list(range(len(segs)))

    oracle_segs = [s.to_oracle_segment() for s in segs]
    results = si.search_batch(QUERIES, k=10)
    for terms, res in zip(QUERIES, results):
        hits, total_found = oracle_search(oracle_segs, terms, k=10)
        assert res.found == total_found, terms
        assert len(res.scores) == len(hits), terms
        for (o_score, o_seg, o_doc), d_score, d_slot in zip(hits, res.scores, res.doc_slots):
            assert si.locate(int(d_slot)) == (o_seg, o_doc), terms
            assert np.float32(d_score) == np.float32(o_score), terms


def test_sharded_matches_single_device(segs):
    mesh = make_mesh(dp=2, seg=4)
    si = ShardedIndex(segs, mesh)
    di = DeviceIndex(segs)
    rs = si.search_batch(QUERIES, k=10)
    rd = di.search_batch(QUERIES, k=10)
    for a, b in zip(rs, rd):
        assert a.found == b.found
        assert np.array_equal(a.scores, b.scores)
        # same (segment, doc) despite different global slot layouts
        assert [si.locate(int(x)) for x in a.doc_slots] == [
            di.locate(int(x)) for x in b.doc_slots
        ]


def test_more_shards_than_segments():
    segs = [build_segment_arrays(make_synthetic_docs(30, 100, seed=20))]
    mesh = make_mesh(dp=1, seg=8)
    si = ShardedIndex(segs, mesh)
    res = si.search_batch([[("w0000", 1.0)]], k=10)[0]
    oracle_hits, found = oracle_search([segs[0].to_oracle_segment()], [("w0000", 1.0)], k=10)
    assert res.found == found
    assert len(res.scores) == len(oracle_hits)


def test_sharded_dense_rows_parity(segs):
    """Force the dense-row (heavy term) path on the sharded kernel."""
    from nextsearch.config import DeviceConfig, EngineConfig

    cfg = EngineConfig(
        device=DeviceConfig(
            mode="fused", posting_block=64, chunk_buckets=(64, 256),
            dense_df_ratio=0.003,  # threshold ~6 docs -> many heavy terms
        )
    )
    mesh = make_mesh(dp=2, seg=4)
    si = ShardedIndex(segs, mesh, config=cfg)
    assert si.n_dense > 0  # the heavy path is actually exercised
    oracle_segs = [s.to_oracle_segment() for s in segs]
    for terms, res in zip(QUERIES, si.search_batch(QUERIES, k=10)):
        hits, total_found = oracle_search(oracle_segs, terms, k=10)
        assert res.found == total_found, terms
        assert len(res.scores) == len(hits), terms
        for (o_score, o_seg, o_doc), d_score, d_slot in zip(
            hits, res.scores, res.doc_slots
        ):
            assert si.locate(int(d_slot)) == (o_seg, o_doc), terms
            assert np.float32(d_score) == np.float32(o_score), terms


def test_sharded_async_pipeline(segs):
    """Depth-2 in-flight launches return the same results as blocking calls."""
    mesh = make_mesh(dp=2, seg=4)
    si = ShardedIndex(segs, mesh)
    h1 = si.search_batch_async(QUERIES[:3], k=10)
    h2 = si.search_batch_async(QUERIES[3:], k=10)
    got = si.search_batch_gather(h1) + si.search_batch_gather(h2)
    want = si.search_batch(QUERIES[:3], k=10) + si.search_batch(QUERIES[3:], k=10)
    for a, b in zip(got, want):
        assert a.found == b.found
        assert np.array_equal(a.scores, b.scores)
        assert np.array_equal(a.doc_slots, b.doc_slots)


def test_common_index_interface(segs):
    """iter_lexicons / slot_capacity / segment_slot_bases agree across index types."""
    mesh = make_mesh(dp=2, seg=4)
    si = ShardedIndex(segs, mesh)
    di = DeviceIndex(segs)

    # every term visible through iter_lexicons on both
    terms_s = set()
    for lex in si.iter_lexicons():
        terms_s.update(lex.keys())
    terms_d = set()
    for lex in di.iter_lexicons():
        terms_d.update(lex.keys())
    assert terms_s == terms_d

    # slot bases land each segment's doc 0 at the right locate() answer
    for idx in (si, di):
        assert idx.slot_capacity > 0
        bases = idx.segment_slot_bases()
        assert len(bases) == len(segs)
        for seg_i, base in enumerate(bases):
            assert idx.locate(base) == (seg_i, 0)


def test_sharded_engine_warmup(tmp_path, segs):
    """Engine.warmup() must work against a mesh-backed (sharded) index."""
    from nextsearch.engine import Engine
    from nextsearch.index.segmentio import write_segment

    segdir = tmp_path / "segments"
    for i, seg in enumerate(segs[:2]):
        write_segment(seg, segdir / f"seg_{i + 1:06d}")
    eng = Engine(tmp_path, mesh=make_mesh(dp=2, seg=4), cache_dir=tmp_path)
    assert eng.reload()
    assert eng.warmup(n_queries=2) > 0
    res = eng.search("w0000 w0001", 5)
    assert res["found"] > 0 and res["results"]


def _oracle_parity(si, segs, queries, k=10):
    oracle_segs = [s.to_oracle_segment() for s in segs]
    results = si.search_batch(queries, k=k)
    for terms, res in zip(queries, results):
        hits, total_found = oracle_search(oracle_segs, terms, k=k)
        assert res.found == total_found, terms
        assert len(res.scores) == len(hits), terms
        for (o_score, o_seg, o_doc), d_score, d_slot in zip(
            hits, res.scores, res.doc_slots
        ):
            assert si.locate(int(d_slot)) == (o_seg, o_doc), terms
            assert np.float32(d_score) == np.float32(o_score), terms


@pytest.mark.parametrize("eps", [2e-3, 1e9])
def test_sharded_fast_heavy_guard(segs, eps):
    """The sharded guarded fast path (per-shard _packed_impl, guards
    pmin-merged across the seg axis): with the default eps the guard
    mostly passes (CPU dots are exact); eps=1e9 trips every non-trivial
    query and the whole batch relaunches the wide HIGHEST kernel (24
    trips > the rescue cap) — both must match the oracle exactly."""
    from nextsearch.config import DeviceConfig, EngineConfig

    cfg = EngineConfig(
        device=DeviceConfig(
            mode="sparse", posting_block=64, chunk_buckets=(64, 256),
            dense_df_ratio=0.02, fast_heavy=True, fast_heavy_eps=eps,
        )
    )
    si = ShardedIndex(segs, make_mesh(dp=2, seg=4), config=cfg)
    r = np.random.default_rng(43)
    words = [f"w{i:04d}" for i in range(200)]
    queries = [
        [(words[int(r.integers(0, 200))], float(r.uniform(0.2, 1.5)))
         for _ in range(int(r.integers(1, 5)))]
        for _ in range(24)
    ]
    _oracle_parity(si, segs, queries)


def test_sharded_guard_trip_host_rescue(segs, monkeypatch):
    """With the rescue cap raised, every tripped query is re-scored by the
    vectorized host oracle with GLOBAL shard-major slot mapping
    (segment_slot_bases) instead of the wide relaunch — bit-exact."""
    from nextsearch.config import DeviceConfig, EngineConfig

    monkeypatch.setenv("NEXTSEARCH_TRIP_RESCUE", "100")
    cfg = EngineConfig(
        device=DeviceConfig(
            mode="sparse", posting_block=64, chunk_buckets=(64, 256),
            dense_df_ratio=0.02, fast_heavy=True, fast_heavy_eps=1e9,
        )
    )
    si = ShardedIndex(segs, make_mesh(dp=1, seg=8), config=cfg)
    r = np.random.default_rng(47)
    words = [f"w{i:04d}" for i in range(200)]
    queries = [
        [(words[int(r.integers(0, 200))], float(r.uniform(0.2, 1.5)))
         for _ in range(int(r.integers(1, 5)))]
        for _ in range(16)
    ] + [[("w0000", 1.0)], [("nosuchterm", 1.0)]]
    _oracle_parity(si, segs, queries)


def test_sharded_row_topk_shortcut_parity(segs):
    """1-term head-heavy queries answered host-side from the per-shard
    row top-k must be oracle-exact (scores, canonical global-slot tie
    order, found = sum of shard-global dfs), including inside a mixed
    batch and at w != 1; the shortcut must NOT fire for terms that are
    light in any shard, duplicate-term, or multi-term queries."""
    from nextsearch.config import DeviceConfig, EngineConfig

    cfg = EngineConfig(
        device=DeviceConfig(
            mode="sparse", posting_block=64, chunk_buckets=(64, 256),
            dense_df_ratio=0.02,
        )
    )
    si = ShardedIndex(
        segs, make_mesh(dp=2, seg=2, devices=jax.devices()[:4]), config=cfg
    )
    assert si._row_topk is not None
    # terms heavy in EVERY shard occurrence (eligible)
    elig = sorted(
        t for t, (off, cnt) in si._lex_slices.items()
        if (si._lex_table[off : off + cnt, 3] >= 0).all()
    )
    assert elig, "fixture must produce all-shard-heavy terms"
    t0 = elig[0]
    q, fills = si._shortcut_single_heavy([[(t0, 1.0)], [(t0, 0.7)]], 10)
    assert fills is not None and 0 in fills and q[0] == []
    # ineligible shapes keep the kernel path
    q2, fills2 = si._shortcut_single_heavy(
        [[(t0, 1.0), (t0, 0.5)], [(t0, 1.0), (elig[-1], 1.0)]], 10
    )
    assert fills2 is None

    queries = [[(t, 1.0)] for t in elig[:5]]
    queries += [[(t0, 0.7)], [(t0, 2.5)], [(t0, 1.0), ("w0150", 0.6)]]
    queries += [[("w0150", 1.0)], [("nosuchterm", 1.0)]]
    _oracle_parity(si, segs, queries)


def test_sharded_light_topk_shortcut_parity(segs):
    """1-term all-shard-LIGHT queries answered host-side from the
    per-shard per-(term, segment) posting top-k must be oracle-exact:
    multi- and single-occurrence terms (prefixes merged by (score desc,
    GLOBAL slot asc)), w != 1 (incomplete-prefix boundary rule per
    occurrence), df above and below the prefix width, and found =
    summed per-occurrence dfs. k > light_topk_k, duplicate-term, and
    mixed heavy/light terms keep the kernel path."""
    from nextsearch.config import DeviceConfig, EngineConfig

    cfg = EngineConfig(
        device=DeviceConfig(
            mode="sparse", posting_block=64, chunk_buckets=(64, 256),
            dense_df_ratio=0.02,
        )
    )
    si = ShardedIndex(
        segs, make_mesh(dp=2, seg=2, devices=jax.devices()[:4]), config=cfg
    )
    assert si._light_topk is not None
    kl = si._light_topk[0].shape[2]

    occ = {
        t: si._lex_table[off : off + cnt]
        for t, (off, cnt) in si._lex_slices.items()
    }
    light = sorted(t for t, ent in occ.items() if (ent[:, 3] < 0).all())
    assert light, "fixture must produce all-light terms"
    multi = [t for t in light if len(occ[t]) >= 2]
    assert multi, "fixture must produce multi-occurrence light terms"
    # fewest-occurrence light terms stand in for single-occurrence ones
    # (every 200-vocab term spans several of the 5 segments here)
    single = sorted(light, key=lambda t: len(occ[t]))[:3]
    big = sorted(
        (t for t in light if int(occ[t][:, 2].max()) > kl),
        key=lambda t: -int(occ[t][:, 2].max()),
    )
    mixed = sorted(
        t for t, ent in occ.items()
        if (ent[:, 3] >= 0).any() and (ent[:, 3] < 0).any()
    )

    q, fills = si._shortcut_single_heavy([[(multi[0], 1.0)]], 10)
    assert fills is not None and q[0] == []
    # k above the stored prefix -> kernel path
    q2, fills2 = si._shortcut_single_heavy([[(multi[0], 1.0)]], kl + 1)
    assert fills2 is None
    # duplicate-term -> kernel path
    q3, fills3 = si._shortcut_single_heavy(
        [[(multi[0], 1.0), (multi[0], 0.5)]], 10
    )
    assert fills3 is None
    # heavy-in-one-shard / light-in-another -> kernel path
    if mixed:
        q4, fills4 = si._shortcut_single_heavy([[(mixed[0], 1.0)]], 10)
        assert fills4 is None

    queries = (
        [[(t, 1.0)] for t in multi[:3] + single[:3]]
        + [[(multi[0], 0.7)], [(single[0], 2.5)]]
        + [[(multi[0], 1.0), ("w0002", 0.6)]]
        + ([[(big[0], 1.0)], [(big[0], 0.9)]] if big else [])
        + ([[(mixed[0], 1.0)]] if mixed else [])
    )
    _oracle_parity(si, segs, queries)


def test_sharded_probe_applies_shortcut(segs):
    """pin_shapes' workload probe must exclude shortcut-eligible 1-term
    queries, so an all-eligible batch pins the minimum C/L budgets."""
    from nextsearch.config import DeviceConfig, EngineConfig

    cfg = EngineConfig(
        device=DeviceConfig(
            mode="sparse", posting_block=64, chunk_buckets=(64, 256),
            dense_df_ratio=0.02,
        )
    )
    si = ShardedIndex(
        segs, make_mesh(dp=2, seg=2, devices=jax.devices()[:4]), config=cfg
    )
    elig = sorted(
        t for t, (off, cnt) in si._lex_slices.items()
        if (si._lex_table[off : off + cnt, 3] < 0).all()
        or (si._lex_table[off : off + cnt, 3] >= 0).all()
    )
    batch = [[(t, 1.0)] for t in elig[:24]]
    # every query is shortcut-eligible -> nothing reaches the kernel plan
    stripped, fills = si._shortcut_single_heavy(batch, 10)
    assert fills is not None and len(fills) == len(batch)
    assert all(q == [] for q in stripped)
    sc = si.pin_shapes([batch], scope_q=True)
    ((qb, pins),) = sc.items()
    assert pins["C"] == 128  # c_pad floor: nothing reached the plan
    raw_pi, _ub = si.plan_sparse(batch)
    tb = raw_pi.shape[2] // 7
    raw_c = si._chunk_budget(
        raw_pi[:, :, tb : 2 * tb], si.config.device.posting_block
    )
    assert raw_c > 1  # the raw plan would have sized real postings


def test_sharded_smaller_batch_reuses_warmed_envelope(segs):
    """A batch smaller than the warmed size (engine cache hits shrink it)
    pads up to the nearest larger warmed Q envelope instead of compiling a
    shape of its own mid-serving; results stay oracle-exact."""
    from nextsearch.config import DeviceConfig, EngineConfig

    cfg = EngineConfig(
        device=DeviceConfig(
            mode="sparse", posting_block=64, chunk_buckets=(64, 256, 1024),
            dense_df_ratio=0.02,
        )
    )
    si = ShardedIndex(
        segs, make_mesh(dp=2, seg=2, devices=jax.devices()[:4]), config=cfg
    )
    r = np.random.default_rng(31)
    words = [f"w{i:04d}" for i in range(220)]
    queries = [
        [(words[int(r.integers(0, 220))], 1.0)
         for _ in range(int(r.integers(2, 4)))]
        for _ in range(16)
    ]
    ((qb, _pins),) = si.pin_shapes([queries], scope_q=True).items()
    assert qb == 16
    for n in (13, 10, 1):
        plan, _u = si.plan_sparse(queries[:n])
        assert plan.shape[1] == qb, (n, plan.shape)
    _oracle_parity(si, segs, queries[:13])
