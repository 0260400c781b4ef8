"""Pipelined serving-path tests (VERDICT r3 item 1).

The HTTP dispatcher keeps `pipeline_depth` launches in flight
(Engine.search_batch_async / search_batch_gather); these tests prove two
overlapping batches return correct, correctly-routed results, that the
batched HTTP endpoint slices results back per request, and that the
write-behind persistence modes keep the reference's on-disk artifacts.
"""

import json
import threading
import time

import pytest

from nextsearch.api.batching import MicroBatcher, SearchBatcher
from nextsearch.api.caches import LRUCache
from nextsearch.api.stats import StatsTracker
from nextsearch.config import BatchingConfig, CacheConfig, EngineConfig
from nextsearch.engine import Engine
from nextsearch.index.builder import build_segment_arrays
from nextsearch.index.segmentio import save_manifest, write_segment


@pytest.fixture()
def engine(tmp_path):
    d = tmp_path / "index"
    (d / "segments").mkdir(parents=True)
    docs = [
        {"cord_uid": f"u{i}", "text": f"covid vaccine term{i % 7} alpha beta study{i % 11}"}
        for i in range(60)
    ]
    write_segment(build_segment_arrays(docs), d / "segments" / "seg_000001")
    save_manifest(d / "manifest.bin", ["seg_000001"])
    e = Engine(d, cache_dir=tmp_path)
    assert e.reload()
    return e


def test_two_phase_matches_blocking(engine):
    reqs = [(f"covid term{i % 7}", 10) for i in range(8)]
    expect = engine.search_batch(list(reqs))
    state = engine.search_batch_async(list(reqs))
    got = engine.search_batch_gather(state)
    for e_res, g_res in zip(expect, got):
        assert g_res["query"] == e_res["query"]
        assert g_res.get("found") == e_res.get("found")
        assert [r["cord_uid"] for r in g_res["results"]] == [
            r["cord_uid"] for r in e_res["results"]
        ]


def test_overlapping_launches_in_flight(engine):
    """Launch two DIFFERENT batches before gathering either; results must
    stay batch-correct (no cross-batch mixing) and match the sync path."""
    a = [(f"covid term{i % 7}", 5) for i in range(4)]
    b = [(f"vaccine study{i % 11}", 5) for i in range(6)]
    expect_a = [r["query"] for r in engine.search_batch(list(a))]
    expect_b = [r["query"] for r in engine.search_batch(list(b))]
    # fresh engine caches would short-circuit; use distinct k to bypass
    a2 = [(q, 4) for q, _ in a]
    b2 = [(q, 4) for q, _ in b]
    sa = engine.search_batch_async(a2)
    sb = engine.search_batch_async(b2)
    ra = engine.search_batch_gather(sa)
    rb = engine.search_batch_gather(sb)
    assert [r["query"] for r in ra] == expect_a
    assert [r["query"] for r in rb] == expect_b
    for r in ra + rb:
        if r["results"]:
            assert r["results"][0]["score"] > 0


def test_pipelined_batcher_correct_routing(engine):
    cfg = BatchingConfig(max_batch=16, window_ms=5.0, pipeline_depth=2)
    batcher = SearchBatcher(engine, cfg)
    try:
        queries = [f"covid term{i % 7} study{i % 11}" for i in range(50)]
        results = {}
        errs = []

        def worker(q):
            try:
                results[q] = batcher.search(q, 10)
            except Exception as e:  # pragma: no cover
                errs.append(e)

        threads = [threading.Thread(target=worker, args=(q,)) for q in queries]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not errs
        assert len(results) == len(set(queries))
        for q, res in results.items():
            assert res["query"] == q  # response routed to its own request
            direct = engine.search(q, 10)
            assert res.get("found") == direct.get("found")
    finally:
        batcher.shutdown()


def test_submit_many_slices_results(engine):
    cfg = BatchingConfig(max_batch=8, window_ms=2.0, pipeline_depth=2)
    batcher = SearchBatcher(engine, cfg)
    try:
        reqs = [(f"covid term{i % 7}", 3) for i in range(20)]  # > max_batch
        out = batcher.search_many(reqs)
        assert len(out) == 20
        for (q, _k), res in zip(reqs, out):
            assert res["query"] == q
    finally:
        batcher.shutdown()


def test_pipelined_exception_propagates():
    calls = {"n": 0}

    def launch(reqs):
        calls["n"] += 1
        if any(r == "boom" for r in reqs):
            raise RuntimeError("launch failed")
        return reqs

    def gather(state):
        return [f"ok:{r}" for r in state]

    b = MicroBatcher(
        config=BatchingConfig(max_batch=4, window_ms=1.0),
        launch_fn=launch, gather_fn=gather, depth=2,
    )
    try:
        assert b.call("x") == "ok:x"
        with pytest.raises(RuntimeError):
            b.call("boom")
        # dispatcher survives the failed launch
        assert b.call("y") == "ok:y"
    finally:
        b.shutdown()


def test_drain_never_exceeds_max_batch():
    """Mixed traffic (singles + submit_many chunks) must never form a flat
    batch wider than max_batch: an oversized batch lands on an UNPINNED Q
    envelope and recompiles mid-serving (ADVICE r4 medium-1)."""
    sizes = []

    def launch(reqs):
        sizes.append(len(reqs))
        return reqs

    def gather(state):
        return [f"ok:{r}" for r in state]

    b = MicroBatcher(
        config=BatchingConfig(max_batch=8, window_ms=20.0),
        launch_fn=launch, gather_fn=gather, depth=2,
    )
    try:
        futs = []
        # a full chunk + a single + another full chunk, queued together so
        # the window WOULD coalesce them without the pushback guard
        futs.append(b.submit_many([f"a{i}" for i in range(8)]))
        futs.append(b.submit("s1"))
        futs.append(b.submit_many([f"b{i}" for i in range(8)]))
        futs.append(b.submit("s2"))
        ra = futs[0].result(timeout=10)
        r1 = futs[1].result(timeout=10)
        rb = futs[2].result(timeout=10)
        r2 = futs[3].result(timeout=10)
        assert ra == [f"ok:a{i}" for i in range(8)]
        assert rb == [f"ok:b{i}" for i in range(8)]
        assert r1 == "ok:s1" and r2 == "ok:s2"
        assert max(sizes) <= 8, f"oversized batch launched: {sizes}"
        assert sum(sizes) == 18  # nothing dropped or duplicated
    finally:
        b.shutdown()


def test_shutdown_fails_queued_units():
    """Units still queued at shutdown get a 'batcher shut down' exception
    instead of hanging their callers forever (ADVICE r4 low-1)."""
    release = threading.Event()

    def launch(reqs):
        release.wait(timeout=10)  # hold the dispatcher busy
        return reqs

    def gather(state):
        return [f"ok:{r}" for r in state]

    b = MicroBatcher(
        config=BatchingConfig(max_batch=1, window_ms=0.1),
        launch_fn=launch, gather_fn=gather, depth=1,
    )
    f1 = b.submit("first")  # dispatcher picks this up and blocks in launch
    time.sleep(0.1)
    f2 = b.submit("stranded")  # still in the queue at shutdown
    b._stop.set()
    b._q.put(([], None, False))
    release.set()
    b._thread.join(timeout=5)
    assert f1.result(timeout=5) == "ok:first"
    with pytest.raises(RuntimeError, match="shut down"):
        f2.result(timeout=5)


def test_warmup_terminates_on_tiny_lexicon(tmp_path):
    """A lexicon with fewer distinct scoreable terms than the max query
    width (4) must not hang warmup's duplicate-resample loop
    (ADVICE r4 medium-2)."""
    d = tmp_path / "index"
    (d / "segments").mkdir(parents=True)
    docs = [{"cord_uid": f"u{i}", "text": "covid covid vaccines"} for i in range(4)]
    write_segment(build_segment_arrays(docs), d / "segments" / "seg_000001")
    save_manifest(d / "manifest.bin", ["seg_000001"])
    e = Engine(d, cache_dir=tmp_path)
    assert e.reload()
    assert e.warmup(sizes=[2]) > 0  # returns instead of spinning forever


def test_cache_write_behind_persists(tmp_path):
    path = tmp_path / "c.json"
    c = LRUCache(10, path, flush_ms=30, tag="cache")
    c.put("a|10", {"query": "a"})
    deadline = time.time() + 5
    while time.time() < deadline:
        if path.exists():
            break
        time.sleep(0.02)
    assert path.exists()
    payload = json.loads(path.read_text())
    assert payload[0]["key"] == "a|10"
    # save() still forces a full synchronous dump
    c.put("b|10", {"query": "b"})
    c.save()
    payload = json.loads(path.read_text())
    assert {p["key"] for p in payload} == {"a|10", "b|10"}


def test_stats_write_behind_and_counts(tmp_path):
    path = tmp_path / "stats.json"
    s = StatsTracker(path, flush_ms=30)
    s.increment_searches(512)
    s.increment_search_cache_hits(3)
    deadline = time.time() + 5
    while time.time() < deadline:
        if path.exists() and json.loads(path.read_text()).get("total_searches") == 512:
            break
        time.sleep(0.02)
    j = json.loads(path.read_text())
    assert j["total_searches"] == 512
    assert j["search_cache_hits"] == 3
    # flush() is idempotent and the sync default still writes per bump
    s.flush()
    s2 = StatsTracker(tmp_path / "s2.json")
    s2.increment_searches()
    assert json.loads((tmp_path / "s2.json").read_text())["total_searches"] == 1


def test_adaptive_batch_sizing():
    """Dispatcher picks the small warmed envelope when the queue is
    shallow (interactive p50) and the full batch when it is deep, and a
    mid-window burst widens the target (VERDICT r4 item 10)."""
    sizes = []
    hold = threading.Event()

    def launch(reqs):
        sizes.append(len(reqs))
        hold.wait(timeout=10)
        return reqs

    def gather(state):
        return [f"ok:{r}" for r in state]

    cfg = BatchingConfig(
        max_batch=32, window_ms=50.0, pipeline_depth=1,
        small_batch=4, small_window_ms=5.0,
    )
    b = MicroBatcher(config=cfg, launch_fn=launch, gather_fn=gather, depth=1)
    try:
        # light load: 2 requests -> one small batch (well under max_batch)
        hold.set()
        f1, f2 = b.submit("a"), b.submit("b")
        assert f1.result(timeout=10) == "ok:a" and f2.result(timeout=10) == "ok:b"
        assert sizes and sizes[0] <= cfg.small_batch
        # heavy load: stall the dispatcher, enqueue a deep backlog, then
        # release — the next drains must target max_batch
        hold.clear()
        stall = b.submit("stall")
        time.sleep(0.05)  # dispatcher now blocked inside launch("stall")
        futs = [b.submit(f"x{i}") for i in range(64)]
        hold.set()
        assert stall.result(timeout=10) == "ok:stall"
        for f in futs:
            f.result(timeout=10)
        assert max(sizes) == cfg.max_batch, sizes
    finally:
        b.shutdown()
