"""Hybrid BM25 + dense rerank tests (BASELINE config 5)."""

import numpy as np
import pytest

from nextsearch.index.builder import build_segment_arrays
from nextsearch.index.segment import DeviceIndex
from nextsearch.models.hybrid import HybridIndex
from nextsearch.models.semantic import SemanticIndex


@pytest.fixture(scope="module")
def setup():
    # Two topic clusters; doc d2 is lexically weaker but semantically closer.
    docs = [
        {"cord_uid": "d0", "text": "covid covid vaccine trial"},
        {"cord_uid": "d1", "text": "covid banana smoothie recipe"},
        {"cord_uid": "d2", "text": "covid corona virus outbreak"},
        {"cord_uid": "d3", "text": "banana apple fruit salad"},
    ]
    seg = build_segment_arrays(docs)
    di = DeviceIndex([seg])

    rng = np.random.default_rng(11)
    base_med = rng.normal(size=16).astype(np.float32)
    base_food = rng.normal(size=16).astype(np.float32)

    def near(v, eps=0.15):
        return v + eps * rng.normal(size=16).astype(np.float32)

    terms = ["covid", "corona", "virus", "vaccine", "trial", "outbreak",
             "banana", "apple", "fruit", "smoothie", "recipe", "salad"]
    vecs = np.stack([
        base_med, near(base_med), near(base_med), near(base_med),
        near(base_med), near(base_med),
        base_food, near(base_food), near(base_food), near(base_food),
        near(base_food), near(base_food),
    ])
    sem = SemanticIndex()
    assert sem.load_from_arrays(terms, vecs)
    return di, sem


def test_rerank_promotes_semantic_match(setup):
    di, sem = setup
    # beta=0: pure dense rerank of BM25 candidates
    hy = HybridIndex(di, sem, beta=0.0)
    q = [[("covid", 1.0), ("virus", 1.0)]]
    bm = di.search_batch(q, k=4)[0]
    hres = hy.search_batch(q, k=4, candidates=4)[0]
    assert hres.found == bm.found
    assert set(hres.doc_slots.tolist()) == set(bm.doc_slots.tolist())
    # d1 (banana smoothie) must sink below the medical docs under dense rerank
    order = hres.doc_slots.tolist()
    assert order.index(1) > order.index(2)


def test_beta_one_matches_bm25_ranking(setup):
    di, sem = setup
    hy = HybridIndex(di, sem, beta=1.0)
    q = [[("covid", 1.0)]]
    bm = di.search_batch(q, k=3)[0]
    hres = hy.search_batch(q, k=3, candidates=4)[0]
    assert hres.doc_slots.tolist() == bm.doc_slots.tolist()
    # hybrid score = bm25 / max_bm25 when beta=1
    np.testing.assert_allclose(
        hres.scores, bm.scores / bm.scores.max(), rtol=1e-6
    )


def test_hybrid_scores_sorted_and_bounded(setup):
    di, sem = setup
    hy = HybridIndex(di, sem, beta=0.5)
    res = hy.search_batch([[("covid", 1.0), ("banana", 1.0)]], k=4)[0]
    s = res.scores
    assert np.all(np.diff(s) <= 0)
    assert np.all(s <= 1.0 + 1e-6) and np.all(s >= 0)


def test_no_candidates(setup):
    di, sem = setup
    hy = HybridIndex(di, sem, beta=0.5)
    res = hy.search_batch([[("zzz", 1.0)]], k=4)[0]
    assert res.found == 0 and len(res.scores) == 0


def test_device_build_matches_host_build(setup, monkeypatch):
    """The on-device doc-embedding build (chunked scatter + normalize)
    reproduces the host np.add.at build to float tolerance, including the
    chunk-boundary padding path."""
    di, sem = setup
    monkeypatch.setenv("NEXTSEARCH_HYBRID_DEVICE_BUILD", "1")
    dev = HybridIndex(di, sem, beta=0.5, chunk=7)  # tiny chunk: many pads
    monkeypatch.setenv("NEXTSEARCH_HYBRID_DEVICE_BUILD", "0")
    host = HybridIndex(di, sem, beta=0.5)
    np.testing.assert_allclose(
        np.asarray(dev.doc_emb), np.asarray(host.doc_emb),
        rtol=1e-5, atol=1e-6,
    )


def test_async_matches_sync(setup):
    """Pipelined async/gather returns the same results as the sync call."""
    hy = HybridIndex(*setup, beta=0.5)
    queries = [
        [("covid", 1.0), ("virus", 1.0)],
        [("banana", 1.0)],
        [("zzz", 1.0)],
    ]
    sync = [hy.search_batch([q], k=4, candidates=4)[0] for q in queries]
    handles = [hy.search_batch_async([q], 4, 4) for q in queries]
    for h, s in zip(handles, sync):
        (a,) = hy.search_batch_gather(h)
        assert a.found == s.found
        assert a.doc_slots.tolist() == s.doc_slots.tolist()
        np.testing.assert_array_equal(a.scores, s.scores)


def test_engine_hybrid_endpoint(tmp_path, monkeypatch):
    """Engine.search_hybrid: response shape + fallback without embeddings."""
    import numpy as np

    from nextsearch.engine import Engine
    from nextsearch.index.builder import build_segment_arrays
    from nextsearch.index.segmentio import save_manifest, write_segment

    d = tmp_path / "index"
    (d / "segments").mkdir(parents=True)
    docs = [
        {"cord_uid": "h1", "text": "covid vaccine trial"},
        {"cord_uid": "h2", "text": "covid corona outbreak"},
    ]
    write_segment(build_segment_arrays(docs), d / "segments" / "seg_000001")
    save_manifest(d / "manifest.bin", ["seg_000001"])
    (d / "metadata.csv").write_text("cord_uid,title\nh1,One\nh2,Two\n")
    # embeddings file -> semantic + hybrid enabled
    rng = np.random.default_rng(0)
    terms = ["covid", "vaccine", "trial", "corona", "outbreak"]
    lines = [
        t + " " + " ".join(f"{x:.5f}" for x in rng.normal(size=12))
        for t in terms
    ]
    (d / "embeddings.vec").write_text("\n".join(lines) + "\n")

    e = Engine(d, cache_dir=tmp_path)
    assert e.reload() and e.sem.enabled
    j = e.search_hybrid("covid vaccine", 5)
    assert j["hybrid"] is True and j["found"] == 2
    assert all("hybrid_score" in r for r in j["results"])
    # cached second call
    j2 = e.search_hybrid("covid vaccine", 5)
    assert j2.get("from_cache") is True
    # plain search unaffected (separate cache key)
    j3 = e.search("covid vaccine", 5)
    assert "hybrid" not in j3


def test_hybrid_over_sparse_mode_index(setup):
    """Hybrid over a sparse-mode index (the production serving mode) must
    match hybrid over the default fused index. The rerank now chains
    directly on the sparse packed DEVICE array (shortcut-free launch, one
    'hybrid' handle, no host round trip — the old hybrid_host path paid a
    synchronous host round trip per batch); guard trips resolve
    through the exact host fix-up at gather."""
    from nextsearch.config import DeviceConfig, EngineConfig

    di, sem = setup
    segs = di.segments
    di_sp = DeviceIndex(
        [segs[0]],
        config=EngineConfig(
            device=DeviceConfig(
                mode="sparse", posting_block=64,
                chunk_buckets=(64, 256), dense_df_ratio=0.001,
            )
        ),
    )
    assert di_sp.n_dense > 0
    hy_f = HybridIndex(di, sem, beta=0.5)
    hy_s = HybridIndex(di_sp, sem, beta=0.5)
    queries = [
        [("covid", 1.0), ("virus", 1.0)],
        [("banana", 1.0)],
        [("covid", 1.0)],  # 1-term: may resolve via host fills
        [("zzz", 1.0)],
    ]
    handle = hy_s.search_batch_async(queries, 4, candidates=4)
    assert handle[0] == "hybrid"  # device-chained rerank, no host sync
    res_s = hy_s.search_batch_gather(handle)
    res_f = hy_f.search_batch(queries, k=4, candidates=4)
    for a, b in zip(res_s, res_f):
        assert a.found == b.found
        assert a.doc_slots.tolist() == b.doc_slots.tolist()
        np.testing.assert_allclose(a.scores, b.scores, rtol=1e-5)


def test_hybrid_sparse_guard_trip_fixup(setup, monkeypatch):
    """With fast_heavy_eps=1e9 every sparse row trips the BM25 guard; the
    hybrid gather must fix those rows up exactly host-side and still match
    the fused-index hybrid results."""
    from nextsearch.config import DeviceConfig, EngineConfig

    di, sem = setup
    segs = di.segments
    di_sp = DeviceIndex(
        [segs[0]],
        config=EngineConfig(
            device=DeviceConfig(
                mode="sparse", posting_block=64,
                chunk_buckets=(64, 256), dense_df_ratio=0.001,
                fast_heavy=True, fast_heavy_eps=1e9,
            )
        ),
    )
    hy_f = HybridIndex(di, sem, beta=0.5)
    hy_s = HybridIndex(di_sp, sem, beta=0.5)
    queries = [
        [("covid", 1.0), ("virus", 1.0)],
        [("banana", 1.0)],
        [("covid", 1.0)],
        [("zzz", 1.0)],
    ]
    res_s = hy_s.search_batch(queries, k=4, candidates=4)
    res_f = hy_f.search_batch(queries, k=4, candidates=4)
    for a, b in zip(res_s, res_f):
        assert a.found == b.found
        assert a.doc_slots.tolist() == b.doc_slots.tolist()
        np.testing.assert_allclose(a.scores, b.scores, rtol=1e-5)


def test_hybrid_all_fill_batch(setup):
    """A batch whose every query resolves via host shortcuts (1-term
    head-heavy) skips the BM25 launch entirely; the hybrid still reranks
    the fill candidates in one device launch and matches the fused-index
    hybrid."""
    from nextsearch.config import DeviceConfig, EngineConfig

    di, sem = setup
    segs = di.segments
    di_sp = DeviceIndex(
        [segs[0]],
        config=EngineConfig(
            device=DeviceConfig(
                mode="sparse", posting_block=64,
                chunk_buckets=(64, 256), dense_df_ratio=0.001,
            )
        ),
    )
    hy_f = HybridIndex(di, sem, beta=0.5)
    hy_s = HybridIndex(di_sp, sem, beta=0.5)
    queries = [[("covid", 1.0)], [("banana", 1.0)]]
    h = hy_s.search_batch_async(queries, 3, candidates=4)
    res_s = hy_s.search_batch_gather(h)
    res_f = hy_f.search_batch(queries, k=3, candidates=4)
    for a, b in zip(res_s, res_f):
        assert a.found == b.found
        assert a.doc_slots.tolist() == b.doc_slots.tolist()
        np.testing.assert_allclose(a.scores, b.scores, rtol=1e-5)
