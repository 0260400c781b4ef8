"""Binary segment format roundtrip tests (reference formats)."""

import numpy as np
import pytest

from nextsearch.index.builder import build_segment_arrays
from nextsearch.index.segmentio import (
    discover_segments,
    load_manifest,
    load_segment,
    save_manifest,
    seg_name,
    write_segment,
)

from conftest import make_synthetic_docs


@pytest.fixture(scope="module")
def seg():
    return build_segment_arrays(make_synthetic_docs(50, 120, seed=6))


def _assert_equal_segments(a, b):
    assert a.N == b.N
    assert np.float32(a.avgdl) == np.float32(b.avgdl)
    assert a.terms == b.terms
    assert np.array_equal(a.term_df, b.term_df)
    assert np.array_equal(a.term_offsets, b.term_offsets)
    assert np.array_equal(a.post_doc, b.post_doc)
    assert np.array_equal(a.post_tf, b.post_tf)
    assert np.array_equal(a.doc_len, b.doc_len)
    assert a.cord_uids == b.cord_uids
    assert a.titles == b.titles
    assert a.relpaths == b.relpaths
    assert np.array_equal(a.legacy_ids, b.legacy_ids)
    assert np.array_equal(a.post_score, b.post_score)


def test_roundtrip_barrels(tmp_path, seg):
    write_segment(seg, tmp_path / "seg_000001", barrels=True)
    # barrel files exist per the reference layout
    assert (tmp_path / "seg_000001" / "barrels.bin").exists()
    assert (tmp_path / "seg_000001" / "lexicon_b000.bin").exists()
    assert (tmp_path / "seg_000001" / "inverted_b063.bin").exists()
    loaded = load_segment(tmp_path / "seg_000001")
    _assert_equal_segments(seg, loaded)


def test_roundtrip_legacy(tmp_path, seg):
    write_segment(seg, tmp_path / "seg_000001", barrels=False)
    assert (tmp_path / "seg_000001" / "lexicon.bin").exists()
    loaded = load_segment(tmp_path / "seg_000001")
    _assert_equal_segments(seg, loaded)


def test_manifest_roundtrip(tmp_path):
    names = [seg_name(1), seg_name(2), seg_name(17)]
    save_manifest(tmp_path / "manifest.bin", names)
    assert load_manifest(tmp_path / "manifest.bin") == names
    assert load_manifest(tmp_path / "missing.bin") == []


def test_discover_segments_fallback(tmp_path):
    (tmp_path / "segments" / "seg_000002").mkdir(parents=True)
    (tmp_path / "segments" / "seg_000001").mkdir()
    (tmp_path / "segments" / "notaseg").mkdir()
    assert discover_segments(tmp_path) == ["seg_000001", "seg_000002"]
    save_manifest(tmp_path / "manifest.bin", ["seg_000002"])
    assert discover_segments(tmp_path) == ["seg_000002"]


def test_forward_bin_doc_major_sorted(tmp_path, seg):
    import struct

    write_segment(seg, tmp_path / "s", barrels=True)
    data = (tmp_path / "s" / "forward.bin").read_bytes()
    n = struct.unpack_from("<I", data, 0)[0]
    assert n == seg.N
    pos = 4
    total = 0
    for _ in range(n):
        cnt = struct.unpack_from("<I", data, pos)[0]
        pos += 4
        pairs = np.frombuffer(data, dtype="<u4", count=2 * cnt, offset=pos)
        tids = pairs[0::2]
        assert np.all(np.diff(tids.astype(np.int64)) > 0)  # termId ascending
        pos += 8 * cnt
        total += cnt
    assert total == seg.num_postings


def test_segment_writer(tmp_path):
    from nextsearch.index.segmentio import SegmentWriter

    w = SegmentWriter()
    w.add_document("u1", "covid vaccine trial", title="T1")
    w.add_document("u2", "the of and")  # all stopwords -> dropped at build
    w.add_document("u3", "vaccine efficacy", relpath="d/3.json")
    assert w.num_documents == 3
    seg = w.write(tmp_path / "segw")
    assert seg.N == 2 and seg.cord_uids == ["u1", "u3"]
    loaded = load_segment(tmp_path / "segw")
    assert loaded.terms == seg.terms
    import numpy as np

    assert np.array_equal(loaded.post_doc, seg.post_doc)
