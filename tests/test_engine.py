"""Engine-level behavior: reload, search JSON shapes, caches, suggest."""

import json

import numpy as np
import pytest

from nextsearch.engine import Engine
from nextsearch.index.builder import build_segment_arrays
from nextsearch.index.segmentio import save_manifest, write_segment

DOCS_SEG1 = [
    {"cord_uid": "uid01", "title": "covid vaccine", "relpath": "d/1.json",
     "text": "covid vaccine efficacy trial results covid"},
    {"cord_uid": "uid02", "title": "flu", "relpath": "d/2.json",
     "text": "influenza vaccine immunity study"},
]
DOCS_SEG2 = [
    {"cord_uid": "uid03", "title": "corona", "relpath": "d/3.json",
     "text": "coronavirus covid transmission dynamics"},
]

METADATA_CSV = """cord_uid,title,authors,publish_time,url,abstract
uid01,COVID Vaccine Trial,"Smith, John; Doe, Jane",2020-03-01,https://a.example/1;https://mirror/1,Efficacy of vaccines.
uid02,Flu Study,Brown Alice,2019-05-10,https://a.example/2,Influenza immunity.
uid03,Corona Dynamics,,2021-01-20,,Spread analysis.
"""


@pytest.fixture()
def index_dir(tmp_path):
    d = tmp_path / "index"
    (d / "segments").mkdir(parents=True)
    write_segment(build_segment_arrays(DOCS_SEG1), d / "segments" / "seg_000001")
    write_segment(build_segment_arrays(DOCS_SEG2), d / "segments" / "seg_000002")
    save_manifest(d / "manifest.bin", ["seg_000001", "seg_000002"])
    (d / "metadata.csv").write_text(METADATA_CSV)
    return d


@pytest.fixture()
def engine(index_dir, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # cache files land in tmp cwd
    e = Engine(index_dir, cache_dir=tmp_path)
    assert e.reload()
    return e


def test_reload_empty_dir(tmp_path):
    e = Engine(tmp_path / "nothing")
    assert not e.reload()


def test_search_response_shape(engine):
    j = engine.search("covid vaccine", 10)
    assert j["query"] == "covid vaccine"
    assert j["k"] == 10
    assert j["segments"] == 2
    assert j["found"] == 3
    results = j["results"]
    assert len(results) == 3
    # uid01 has covid x2 + vaccine -> top hit
    top = results[0]
    assert top["cord_uid"] == "uid01"
    assert top["segment"] == "seg_000001"
    assert top["docId"] == 0
    assert top["title"] == "COVID Vaccine Trial"
    assert top["url"] == "https://a.example/1"  # truncated at ';'
    assert top["publish_time"] == "2020-03-01"
    assert top["author"] == "Smith et al."
    # uid03 has no url/author -> keys omitted
    r3 = [r for r in results if r["cord_uid"] == "uid03"][0]
    assert "url" not in r3 and "author" not in r3
    assert r3["title"] == "Corona Dynamics"


def test_search_k_clamped(engine):
    assert engine.search("covid", 0)["k"] == 1
    assert engine.search("covid", 500)["k"] == 100


def test_search_empty_terms_shape(engine):
    # stopwords-only query: no "found" key, not cached
    j = engine.search("the of and", 10)
    assert j["results"] == [] and "found" not in j
    j2 = engine.search("the of and", 10)
    assert "from_cache" not in j2


def test_search_cache_roundtrip(engine):
    j1 = engine.search("covid", 10)
    assert "from_cache" not in j1
    j2 = engine.search("covid", 10)
    assert j2["from_cache"] is True
    assert j2["found"] == j1["found"]
    # different k -> different cache key
    j3 = engine.search("covid", 5)
    assert "from_cache" not in j3


def test_cache_persisted_and_reloaded(engine, tmp_path):
    engine.search("covid", 10)
    data = json.loads((tmp_path / "search_cache.json").read_text())
    assert data and data[0]["key"] == "covid|10"
    # fresh engine loads the cache at reload
    e2 = Engine(engine.index_dir, cache_dir=tmp_path)
    assert e2.reload()
    assert e2.search("covid", 10)["from_cache"] is True


def test_cached_result_not_polluted_by_timing(engine):
    j1 = engine.search("vaccine", 10)
    j1["search_time_ms"] = 123.0  # server-side mutation
    j2 = engine.search("vaccine", 10)
    assert "search_time_ms" not in j2


def test_search_batch_mixed_cache(engine):
    engine.search("covid", 10)
    out = engine.search_batch([("covid", 10), ("influenza", 10), ("the", 10)])
    assert out[0]["from_cache"] is True
    assert out[1]["found"] == 1 and "from_cache" not in out[1]
    assert "found" not in out[2]


def test_scores_match_oracle(engine):
    from nextsearch.index.oracle import oracle_search

    segs = [s.to_oracle_segment() for s in engine.index.segments]
    j = engine.search("covid vaccine trial", 10)
    hits, found = oracle_search(
        segs, [("covid", 1.0), ("vaccine", 1.0), ("trial", 1.0)], 10
    )
    assert j["found"] == found
    for r, (score, seg_idx, doc_id) in zip(j["results"], hits):
        assert np.float32(r["score"]) == np.float32(score)


def test_suggest_shape_and_clamp(engine):
    j = engine.suggest("cov", 5)
    assert j["query"] == "cov" and j["limit"] == 5
    assert j["suggestions"][0] == "covid"  # df 3 across segments
    assert engine.suggest("cov", 99)["limit"] == 10
    assert engine.suggest("cov", 0)["limit"] == 1
    assert engine.suggest("zzz", 5)["suggestions"] == []


def test_autocomplete_df_summed_across_segments(engine):
    # covid appears in seg1 (df=1? uid01) and seg2 (uid03): df sums
    i = engine.ac.terms.index("covid")
    # via suggestion ordering: covid (df 2) ranks above coronavirus (df 1)
    s = engine.suggest("co", 10)["suggestions"]
    assert s.index("covid") < s.index("coronavirus")


def test_warmup(engine):
    assert engine.warmup(k_values=(10,), n_queries=4) == 1
    # warmup must not pollute caches or results
    j = engine.search("covid", 10)
    assert j["found"] == 2 and "from_cache" not in j
