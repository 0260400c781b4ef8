"""Degraded-mode / failure-detection semantics (SURVEY.md §5).

The reference: semantic search silently disabled without embeddings; reload
failure aborts without clobbering state; AI endpoints 503 without config.
"""

import numpy as np

from nextsearch.engine import Engine
from nextsearch.index.builder import build_segment_arrays
from nextsearch.index.segmentio import save_manifest, write_segment


def _make_index(tmp_path, name="index"):
    d = tmp_path / name
    (d / "segments").mkdir(parents=True)
    docs = [{"cord_uid": "u1", "text": "covid vaccine"}]
    write_segment(build_segment_arrays(docs), d / "segments" / "seg_000001")
    save_manifest(d / "manifest.bin", ["seg_000001"])
    (d / "metadata.csv").write_text("cord_uid,title\nu1,T\n")
    return d


def test_semantic_silently_disabled_without_embeddings(tmp_path):
    e = Engine(_make_index(tmp_path), cache_dir=tmp_path)
    assert e.reload()
    assert not e.sem.enabled
    # search works, weights are all 1.0
    assert e.search("covid", 10)["found"] == 1


def test_bad_embeddings_file_disables_semantic(tmp_path):
    d = _make_index(tmp_path)
    (d / "embeddings.vec").write_text("garbage no vectors here\n")
    e = Engine(d, cache_dir=tmp_path)
    assert e.reload()
    assert not e.sem.enabled  # found but unusable -> disabled, search still ok
    assert e.search("covid", 10)["found"] == 1


def test_reload_failure_keeps_previous_index(tmp_path):
    d = _make_index(tmp_path)
    e = Engine(d, cache_dir=tmp_path)
    assert e.reload()
    assert e.search("covid", 10)["found"] == 1

    # corrupt the manifest to point at a missing segment
    save_manifest(d / "manifest.bin", ["seg_999999"])
    assert not e.reload()
    # old index still serves (cache cleared? reference keeps serving old segs)
    j = e.search("vaccine", 10)
    assert j["found"] == 1


def test_missing_metadata_csv_searches_without_fields(tmp_path):
    d = _make_index(tmp_path)
    (d / "metadata.csv").unlink()
    e = Engine(d, cache_dir=tmp_path)
    assert e.reload()
    j = e.search("covid", 10)
    assert j["found"] == 1
    r = j["results"][0]
    assert "title" not in r and "url" not in r


def test_structured_logging(capsys, monkeypatch):
    from nextsearch.utils import logging as nslog

    monkeypatch.setenv("NEXTSEARCH_LOG_JSON", "1")
    nslog.log("reload", "loaded", segments=3)
    err = capsys.readouterr().err
    import json

    rec = json.loads(err.strip())
    assert rec["tag"] == "reload" and rec["segments"] == 3

    monkeypatch.delenv("NEXTSEARCH_LOG_JSON")
    monkeypatch.setenv("NEXTSEARCH_LOG_LEVEL", "error")
    nslog.log("cache", "hidden info")
    assert capsys.readouterr().err == ""
    nslog.error("cache", "shown")
    assert "[cache] shown" in capsys.readouterr().err
