"""Concurrency property tests (SURVEY.md §5: replace sanitizers).

The reference serializes everything behind one mutex; our engine must stay
consistent under concurrent searches, suggests, cache hits, and reloads.
"""

import threading

import pytest

from nextsearch.engine import Engine
from nextsearch.index.builder import build_segment_arrays
from nextsearch.index.segmentio import save_manifest, write_segment


@pytest.fixture()
def engine(tmp_path):
    d = tmp_path / "index"
    (d / "segments").mkdir(parents=True)
    docs = [
        {"cord_uid": f"u{i}", "text": f"covid vaccine term{i % 7} study"}
        for i in range(30)
    ]
    write_segment(build_segment_arrays(docs), d / "segments" / "seg_000001")
    save_manifest(d / "manifest.bin", ["seg_000001"])
    (d / "metadata.csv").write_text(
        "cord_uid,title\n" + "".join(f"u{i},T{i}\n" for i in range(30))
    )
    e = Engine(d, cache_dir=tmp_path)
    assert e.reload()
    return e


def test_search_serves_during_slow_reload(engine, monkeypatch, tmp_path):
    """Zero-downtime reload (VERDICT r4 item 4): while a reload's heavy
    build runs (simulated by a slowed segment load), searches must complete
    promptly with complete OLD-index results — not stall behind engine.mtx
    for the duration of the build. After the reload, the new segment is
    visible."""
    import time

    from nextsearch.index import artifacts as _artifacts
    from nextsearch.index.builder import build_segment_arrays
    from nextsearch.index.segmentio import save_manifest, write_segment

    d = engine.index_dir
    docs2 = [
        {"cord_uid": f"v{i}", "text": "zebra quagga newterm covid"}
        for i in range(10)
    ]
    write_segment(build_segment_arrays(docs2), d / "segments" / "seg_000002")
    save_manifest(d / "manifest.bin", ["seg_000001", "seg_000002"])

    real_load = _artifacts.load_segment_cached
    slow = 0.8

    def slow_load(*a, **kw):
        time.sleep(slow)
        return real_load(*a, **kw)

    monkeypatch.setattr(_artifacts, "load_segment_cached", slow_load)

    # pay one-time XLA compilation BEFORE the reload so mid-reload latency
    # measures lock contention, not compile time
    for i in range(7):
        engine.search(f"covid term{i}", 10)

    t = threading.Thread(target=lambda: engine.reload())
    t.start()
    time.sleep(0.1)  # let reload enter the slow build
    lat = []
    seen_segments = set()
    while t.is_alive():
        # same 2-term shape as the precompiled queries (no fresh XLA
        # compile) but uncached, so the whole un-snapshotted path runs
        t0 = time.perf_counter()
        res = engine.search(f"study term{len(lat) % 7}", 10)
        lat.append(time.perf_counter() - t0)
        seen_segments.add(res["segments"])
        if len(lat) >= 3 and not t.is_alive():
            break
    t.join(timeout=30)
    assert len(lat) >= 3, "reload finished before any mid-reload searches ran"
    # searches during the ~1.6s build must not have waited for it
    assert max(lat) < slow / 2, f"search stalled behind reload: {max(lat):.3f}s"
    # mid-reload searches saw a consistent snapshot (old or new, never mixed)
    assert seen_segments <= {1, 2}
    # post-reload: the new segment serves
    res = engine.search("zebra quagga", 10)
    assert res["segments"] == 2
    assert res["found"] >= 10


def test_concurrent_search_suggest_reload(engine):
    errors = []
    stop = threading.Event()

    def searcher(seed):
        i = 0
        while not stop.is_set():
            try:
                j = engine.search(f"covid term{(seed + i) % 7}", 10)
                assert j["query"].startswith("covid")
                if "found" in j:
                    assert j["found"] >= 0
                i += 1
            except Exception as e:  # pragma: no cover
                errors.append(e)
                return

    def suggester():
        while not stop.is_set():
            try:
                s = engine.suggest("te", 5)
                assert isinstance(s["suggestions"], list)
            except Exception as e:  # pragma: no cover
                errors.append(e)
                return

    def reloader():
        for _ in range(3):
            try:
                assert engine.reload()
            except Exception as e:  # pragma: no cover
                errors.append(e)
                return

    threads = (
        [threading.Thread(target=searcher, args=(s,)) for s in range(4)]
        + [threading.Thread(target=suggester) for _ in range(2)]
        + [threading.Thread(target=reloader)]
    )
    for t in threads:
        t.start()
    import time

    time.sleep(2.0)
    stop.set()
    for t in threads:
        t.join(timeout=30)
    assert not errors, errors
    # engine still consistent after the storm
    assert engine.search("covid", 10)["found"] == 30


def test_concurrent_cache_writes(engine):
    """Parallel distinct queries: every cache entry lands intact."""
    qs = [f"term{i % 7} covid" for i in range(14)]
    threads = [
        threading.Thread(target=lambda q=q: engine.search(q, 10)) for q in qs
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    for q in set(qs):
        j = engine.search(q, 10)
        assert j.get("from_cache") is True


def test_suggest_not_serialized_behind_slow_search(engine):
    """A slow device search must not block suggests (VERDICT r1 weak-9).

    The suggest path snapshots engine.ac instead of holding engine.mtx
    across the device call; simulate a slow search holding the lock and
    assert suggests still complete promptly.
    """
    import time

    release = threading.Event()
    started = threading.Event()

    def slow_search():
        # Hold engine.mtx the way a long snapshot/reload section would.
        with engine.mtx:
            started.set()
            release.wait(timeout=10)

    t = threading.Thread(target=slow_search, daemon=True)
    t.start()
    assert started.wait(timeout=5)
    t0 = time.time()
    out = engine.suggest("cov", 5)
    dt = time.time() - t0
    release.set()
    t.join(timeout=5)
    assert out["suggestions"], out
    assert dt < 2.0, f"suggest blocked behind engine.mtx for {dt:.1f}s"


def test_reload_in_place_mode(engine, monkeypatch):
    """NEXTSEARCH_RELOAD_IN_PLACE=1 (HBM-saturated deployments: two
    device indexes cannot coexist) drops the old index before the build;
    reload still succeeds and serves afterwards."""
    monkeypatch.setenv("NEXTSEARCH_RELOAD_IN_PLACE", "1")
    assert engine.reload()
    res = engine.search("covid", 5)
    assert res["found"] > 0
