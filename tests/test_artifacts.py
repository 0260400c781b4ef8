"""Device-artifact checkpoint roundtrip + staleness semantics."""

import os
import time

import numpy as np
import pytest

from nextsearch.index.artifacts import (
    artifact_fresh,
    load_artifact,
    load_segment_cached,
    save_artifact,
)
from nextsearch.index.builder import build_segment_arrays
from nextsearch.index.segmentio import write_segment

from conftest import make_synthetic_docs


@pytest.fixture(scope="module")
def seg():
    return build_segment_arrays(make_synthetic_docs(60, 150, seed=8))


def _assert_equal(a, b):
    assert a.terms == b.terms
    assert a.N == b.N and np.float32(a.avgdl) == np.float32(b.avgdl)
    for f in ("term_df", "term_offsets", "post_doc", "post_tf", "doc_len",
              "legacy_ids", "post_score"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert a.cord_uids == b.cord_uids and a.titles == b.titles


def test_roundtrip(tmp_path, seg):
    save_artifact(seg, tmp_path)
    loaded = load_artifact(tmp_path)
    assert loaded is not None
    _assert_equal(seg, loaded)


def test_missing_artifact(tmp_path):
    assert load_artifact(tmp_path) is None
    assert not artifact_fresh(tmp_path)


def test_cached_load_builds_and_reuses(tmp_path, seg):
    segdir = tmp_path / "seg_000001"
    write_segment(seg, segdir)
    assert not artifact_fresh(segdir)
    first = load_segment_cached(segdir)
    assert artifact_fresh(segdir)
    _assert_equal(seg, first)
    # second load comes from the artifact
    second = load_segment_cached(segdir)
    _assert_equal(first, second)


def test_stale_artifact_rebuilt(tmp_path, seg):
    segdir = tmp_path / "seg_000001"
    write_segment(seg, segdir)
    load_segment_cached(segdir)
    assert artifact_fresh(segdir)
    # backdate the artifact behind the binaries -> stale -> rebuilt
    past = time.time() - 3600
    os.utime(segdir / "device_arrays.npz", (past, past))
    assert not artifact_fresh(segdir)
    again = load_segment_cached(segdir)
    _assert_equal(seg, again)
    assert artifact_fresh(segdir)


def test_unicode_titles_roundtrip(tmp_path):
    docs = [
        {"cord_uid": "u1", "title": "naïve Bayes — étude", "text": "alpha beta"},
        {"cord_uid": "u2", "title": "普通のタイトル", "text": "beta gamma"},
    ]
    seg = build_segment_arrays(docs)
    save_artifact(seg, tmp_path)
    loaded = load_artifact(tmp_path)
    assert loaded.titles == [d["title"] for d in docs]


def test_artifact_stale_on_bm25_param_change(tmp_path):
    """An artifact baked with one (k1, b) must not serve another's scores."""
    import numpy as np

    from nextsearch.index.artifacts import (
        load_artifact,
        load_segment_cached,
        save_artifact,
    )
    from nextsearch.index.builder import build_segment_arrays, eager_scores
    from nextsearch.index.segmentio import write_segment

    from conftest import make_synthetic_docs

    seg = build_segment_arrays(
        make_synthetic_docs(30, 80, seed=42), k1=1.2, b=0.75
    )
    segdir = tmp_path / "seg_000001"
    write_segment(seg, segdir)
    save_artifact(seg, segdir, k1=1.2, b=0.75)

    # same params -> served from the artifact
    assert load_artifact(segdir, k1=1.2, b=0.75) is not None
    # different params -> stale
    assert load_artifact(segdir, k1=2.0, b=0.4) is None
    # cached load with new params rebuilds with matching scores
    seg2 = load_segment_cached(segdir, k1=2.0, b=0.4)
    np.testing.assert_array_equal(
        seg2.post_score, eager_scores(seg2, k1=2.0, b=0.4)
    )
    # and re-publishes an artifact tagged with the new params
    assert load_artifact(segdir, k1=2.0, b=0.4) is not None
