"""Offline pipeline CLI tests: make_synthetic -> forwardindex -> lexicon."""

import json

import numpy as np
import pytest

from nextsearch.index.segmentio import load_forward_stage, load_segment, save_manifest
from nextsearch.tools import adddocument, forwardindex, lexicon, make_synthetic


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    make_synthetic.main([str(root), "--n", "40", "--vocab", "300", "--seed", "3"])
    return root


def test_pipeline_end_to_end(corpus, tmp_path):
    segdir = tmp_path / "segments" / "seg_000001"
    assert forwardindex.run(str(corpus), str(segdir)) == 0
    for f in ("docs.bin", "stats.bin", "forward.bin", "terms.bin"):
        assert (segdir / f).exists(), f
    assert not (segdir / "barrels.bin").exists()  # stage 1 only

    assert lexicon.run(str(segdir)) == 0
    assert (segdir / "barrels.bin").exists()

    seg = load_segment(segdir)
    assert seg.N == 40
    assert np.array_equal(np.diff(seg.term_offsets), seg.term_df)
    # loading via forward stage gives identical postings
    fwd = load_forward_stage(segdir)
    assert fwd.terms == seg.terms
    assert np.array_equal(fwd.post_doc, seg.post_doc)
    assert np.array_equal(fwd.post_tf, seg.post_tf)


def test_adddocument_and_search(corpus, tmp_path):
    index_dir = tmp_path / "index"
    segdir = index_dir / "segments" / "seg_000001"
    forwardindex.run(str(corpus), str(segdir))
    lexicon.run(str(segdir))
    save_manifest(index_dir / "manifest.bin", ["seg_000001"])

    doc = {
        "paper_id": "nd",
        "title": "axolotl research",
        "body_text": [{"text": "axolotl regeneration axolotl covid"}],
    }
    (corpus / "document_parses" / "pmc_json" / "nd.xml.json").write_text(
        json.dumps(doc)
    )
    rc = adddocument.run(
        str(index_dir), str(corpus),
        "document_parses/pmc_json/nd.xml.json", "nd", "axolotl research",
    )
    assert rc == 0
    from nextsearch.index.segmentio import discover_segments

    assert discover_segments(index_dir) == ["seg_000001", "seg_000002"]
    seg2 = load_segment(index_dir / "segments" / "seg_000002")
    assert seg2.N == 1 and seg2.cord_uids == ["nd"]
    # tf = 3: twice in body_text + once in the JSON title (title is indexed)
    docs, tfs = seg2.postings("axolotl")
    assert docs.tolist() == [0] and tfs.tolist() == [3]


def test_slice_cord19(corpus, tmp_path):
    from nextsearch.tools import slice_cord19

    out = tmp_path / "slice"
    rc = slice_cord19.main(
        ["--in_root", str(corpus), "--out_root", str(out), "--n", "10",
         "--seed", "7", "--prefer", "pmc"]
    )
    assert rc == 0
    lines = (out / "metadata.csv").read_text().strip().split("\n")
    assert len(lines) == 11  # header + 10
    # referenced JSONs copied
    from nextsearch.utils.csvutil import csv_row

    cols = csv_row(lines[0])
    i_pmc = cols.index("pmc_json_files")
    for line in lines[1:]:
        rel = csv_row(line)[i_pmc]
        assert (out / rel).exists()


def test_backup_data(tmp_path, monkeypatch):
    from nextsearch.tools import backup_data

    monkeypatch.chdir(tmp_path)
    (tmp_path / "stats.json").write_text("{}")
    (tmp_path / "feedback.json").write_text("{}")
    rc = backup_data.main(["b.zip", str(tmp_path)])
    assert rc == 0
    import zipfile

    with zipfile.ZipFile(tmp_path / "b.zip") as z:
        assert set(z.namelist()) == {"stats.json", "feedback.json"}
