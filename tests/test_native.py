"""Native C++ library parity with the pure-Python implementations."""

import numpy as np
import pytest

from nextsearch import native
from nextsearch.index.builder import build_segment_arrays
from nextsearch.utils.textutil import tokenize

from conftest import make_synthetic_docs

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library unavailable (no toolchain)"
)


TEXTS = [
    "Hello, World! 123",
    "COVID-19 mRNA-vaccine naïve αβγ test",
    "",
    "the quick brown fox a an",
    "abc123def x_y",
    "ALL CAPS and MiXeD",
]


def test_tokenize_parity():
    for t in TEXTS:
        assert native.tokenize_native(t) == tokenize(t), t


def test_builder_parity_small():
    texts = [
        "covid vaccine trial covid",
        "vaccine efficacy study",
        "the a an of to",  # all stopwords -> skipped
        "covid study outcomes",
    ]
    b = native.NativeForwardBuilder()
    lens = [b.add_doc(t) for t in texts]
    assert lens == [4, 3, 0, 3]
    terms, legacy_ids, term_df, term_offsets, post_doc, post_tf, doc_len, total = b.finish()
    b.close()

    py = build_segment_arrays(
        [{"cord_uid": f"u{i}", "text": t} for i, t in enumerate(texts)],
        with_scores=False,
    )
    assert terms == py.terms
    assert np.array_equal(legacy_ids, py.legacy_ids)
    assert np.array_equal(term_df, py.term_df)
    assert np.array_equal(term_offsets, py.term_offsets)
    assert np.array_equal(post_doc, py.post_doc)
    assert np.array_equal(post_tf, py.post_tf)
    assert np.array_equal(doc_len, py.doc_len)
    assert total == int(py.doc_len.sum())


def test_builder_parity_synthetic():
    docs = make_synthetic_docs(120, 400, seed=9)
    b = native.NativeForwardBuilder()
    for d in docs:
        b.add_doc(" ".join(d["tokens"]))
    terms, legacy_ids, term_df, term_offsets, post_doc, post_tf, doc_len, total = b.finish()
    b.close()

    py = build_segment_arrays(docs, with_scores=False)
    assert terms == py.terms
    assert np.array_equal(legacy_ids, py.legacy_ids)
    assert np.array_equal(term_df, py.term_df)
    assert np.array_equal(post_doc, py.post_doc)
    assert np.array_equal(post_tf, py.post_tf)
    assert np.array_equal(doc_len, py.doc_len)


def test_csv_scan_parity(tmp_path):
    from nextsearch.index.metadata import load_metadata_uid_meta

    csv = (
        "cord_uid,title,authors\n"
        'abc1,"Title, with comma",Smith\n'
        "abc2,Plain,Jones\n"
        ',empty uid,skipped\n'
        'abc1,dup kept-first,X\n'
        '"q""uid",quoted,Y\n'
    )
    p = tmp_path / "metadata.csv"
    p.write_text(csv)

    rows = native.scan_csv_offsets_native(csv.encode(), uid_col=0)
    # python reference map (first occurrence wins)
    pymap = load_metadata_uid_meta(p)
    native_map = {}
    for uid, off, ln in rows:
        if uid not in native_map:
            native_map[uid] = (off, ln)
    assert set(native_map) == set(pymap)
    for uid, info in pymap.items():
        assert native_map[uid] == (info.file_offset, info.row_length), uid


def test_native_renderer_parity(tmp_path):
    """Native render path (caches.Rendered fragments) must reproduce the
    Python dict render field-for-field: scores, doc info, metadata fields
    (title/url-cut-at-';'/publish_time/author), escaping of quotes and
    non-ASCII, and missing-metadata omission."""
    import json
    from dataclasses import replace

    from nextsearch.config import DEFAULT_CONFIG
    from nextsearch.engine import Engine
    from nextsearch.index.builder import build_segment_arrays
    from nextsearch.index.segmentio import save_manifest, write_segment

    if not native.available():
        pytest.skip("native library unavailable")

    d = tmp_path / "index"
    (d / "segments").mkdir(parents=True)
    docs1 = [
        {"cord_uid": "uid01", "text": "covid vaccine trial covid"},
        {"cord_uid": "uid02", "text": "influenza vaccine study"},
    ]
    docs2 = [{"cord_uid": "uid03", "text": "covid transmission dynamics"}]
    write_segment(build_segment_arrays(docs1), d / "segments" / "seg_000001")
    write_segment(build_segment_arrays(docs2), d / "segments" / "seg_000002")
    save_manifest(d / "manifest.bin", ["seg_000001", "seg_000002"])
    (d / "metadata.csv").write_text(
        "cord_uid,title,authors,publish_time,url,abstract\n"
        'uid01,"Vaccine \\"quoted\\" titré","Müller, Hans; Doe, J",2020-03-01,'
        "https://a.example/1;https://mirror/1,Efficacy.\n"
        "uid02,Flu Study,Brown Alice,2019-05-10,https://a.example/2,Flu.\n",
        encoding="utf-8",
    )  # uid03 has NO metadata row

    queries = [("covid vaccine", 10), ("influenza", 3), ("covid", 2)]

    e_py = Engine(d, cache_dir=tmp_path / "c1")
    assert e_py.reload()
    expect = e_py.search_batch(list(queries))

    e_nat = Engine(
        d,
        config=replace(DEFAULT_CONFIG, native_render=True),
        cache_dir=tmp_path / "c2",
    )
    assert e_nat.reload()
    got = e_nat.search_batch(list(queries))

    for exp, r in zip(expect, got):
        assert hasattr(r, "fragment"), "native path must return Rendered"
        assert not r.cached
        assert json.loads(r.fragment) == exp
    # cache hit: same fragment, cached flag set; engine.search() converts
    hit = e_nat.search_batch([("covid vaccine", 10)])[0]
    assert hit.cached and json.loads(hit.fragment) == expect[0]
    as_dict = e_nat.search("influenza", 3)
    assert as_dict.pop("from_cache") is True
    assert as_dict == expect[1]
