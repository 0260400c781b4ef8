"""Fuzz parity: random corpora + random queries, Engine JSON vs oracle."""

import numpy as np
import pytest

from nextsearch.engine import Engine
from nextsearch.index.builder import build_segment_arrays
from nextsearch.index.oracle import oracle_search
from nextsearch.index.segmentio import save_manifest, write_segment
from nextsearch.utils.textutil import filter_terms, tokenize

from conftest import make_synthetic_docs


@pytest.mark.parametrize("seed", [101, 202, 303])
def test_engine_matches_oracle_random_corpus(tmp_path, seed):
    rng = np.random.default_rng(seed)
    n_segs = int(rng.integers(1, 4))
    d = tmp_path / "index"
    (d / "segments").mkdir(parents=True)
    names = []
    segs = []
    for s in range(n_segs):
        docs = make_synthetic_docs(
            int(rng.integers(20, 120)), int(rng.integers(50, 400)),
            seed=seed + s, avg_len=int(rng.integers(20, 90)),
        )
        seg = build_segment_arrays(docs)
        name = f"seg_{s + 1:06d}"
        write_segment(seg, d / "segments" / name)
        names.append(name)
        segs.append(seg)
    save_manifest(d / "manifest.bin", names)
    (d / "metadata.csv").write_text("cord_uid,title\n")

    e = Engine(d, cache_dir=tmp_path)
    assert e.reload()
    oracle_segs = [s.to_oracle_segment() for s in e.index.segments]

    vocab = sorted({t for seg in segs for t in seg.terms})
    for _ in range(15):
        n_terms = int(rng.integers(1, 5))
        qterms = [vocab[int(rng.integers(0, len(vocab)))] for _ in range(n_terms)]
        if rng.random() < 0.2:
            qterms.append("zzz_missing_term")
        query = " ".join(qterms)
        k = int(rng.integers(1, 30))

        j = e.search(query, k)
        base = filter_terms(tokenize(query))
        weighted = [(t, 1.0) for t in base]
        hits, found = oracle_search(oracle_segs, weighted, max(1, min(k, 100)))
        if not base:
            assert "found" not in j
            continue
        assert j["found"] == found, query
        assert len(j["results"]) == len(hits), query
        for r, (o_s, o_seg, o_doc) in zip(j["results"], hits):
            assert r["segment"] == names[o_seg], query
            assert r["docId"] == o_doc, query
            assert np.float32(r["score"]) == np.float32(o_s), query


def test_expansion_weights_flow_to_scoring(tmp_path):
    """Engine search with embeddings == oracle fed the same expansion."""
    d = tmp_path / "index"
    (d / "segments").mkdir(parents=True)
    docs = [
        {"cord_uid": "e1", "text": "covid spread fast"},
        {"cord_uid": "e2", "text": "corona spread slow"},
        {"cord_uid": "e3", "text": "banana bread recipe"},
    ]
    seg = build_segment_arrays(docs)
    write_segment(seg, d / "segments" / "seg_000001")
    save_manifest(d / "manifest.bin", ["seg_000001"])
    (d / "metadata.csv").write_text("cord_uid,title\n")
    # covid ~ corona embeddings
    rng = np.random.default_rng(5)
    base = rng.normal(size=16)
    vecs = {
        "covid": base,
        "corona": base + 0.05 * rng.normal(size=16),
        "spread": rng.normal(size=16),
        "banana": rng.normal(size=16),
    }
    lines = [
        t + " " + " ".join(f"{x:.6f}" for x in v) for t, v in vecs.items()
    ]
    (d / "embeddings.vec").write_text("\n".join(lines) + "\n")

    e = Engine(d, cache_dir=tmp_path)
    assert e.reload() and e.sem.enabled

    ecfg = e.config.expansion
    expanded = e.sem.expand(
        ["covid"], per_term=ecfg.per_term, global_topk=ecfg.global_topk,
        min_sim=ecfg.min_sim, alpha=ecfg.alpha,
        max_total_terms=ecfg.max_total_terms,
    )
    assert any(t == "corona" for t, _ in expanded)  # expansion really fired

    j = e.search("covid", 10)
    hits, found = oracle_search([seg.to_oracle_segment()], expanded, 10)
    assert j["found"] == found == 2  # covid doc + corona doc
    for r, (o_s, _o_seg, o_doc) in zip(j["results"], hits):
        assert r["docId"] == o_doc
        assert np.float32(r["score"]) == np.float32(o_s)
