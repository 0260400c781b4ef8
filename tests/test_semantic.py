"""Semantic expansion parity tests (reference: src/semantic_embedding.cpp)."""

import numpy as np
import pytest

from nextsearch.models.semantic import SemanticIndex


def _make_index():
    # hand-crafted 12-dim vectors with known cosine structure
    rng = np.random.default_rng(7)
    base = rng.normal(size=12).astype(np.float32)

    def near(v, eps):
        return v + eps * rng.normal(size=12).astype(np.float32)

    terms = ["covid", "corona", "virus", "vaccine", "banana", "apple"]
    vecs = np.stack(
        [
            base,                      # covid
            near(base, 0.1),           # corona  ~ covid
            near(base, 0.3),           # virus   ~ covid (less)
            rng.normal(size=12).astype(np.float32),  # vaccine unrelated
            rng.normal(size=12).astype(np.float32),  # banana
            rng.normal(size=12).astype(np.float32),  # apple
        ]
    )
    idx = SemanticIndex()
    assert idx.load_from_arrays(terms, vecs)
    return idx


def test_expand_disabled_returns_originals():
    idx = SemanticIndex()
    out = idx.expand(["covid", "vaccine"])
    assert sorted(out) == [("covid", 1.0), ("vaccine", 1.0)]


def test_expand_originals_weight_one_and_banned():
    idx = _make_index()
    out = idx.expand(["covid"], per_term=3, global_topk=0, min_sim=0.5, alpha=0.6)
    d = dict(out)
    assert d["covid"] == 1.0
    # covid itself is banned from neighbor results; corona should appear
    assert "corona" in d
    assert 0 < d["corona"] <= 0.6
    # neighbor weight = alpha * sim
    emb = idx._emb_host
    sim = float(np.dot(emb[0], emb[1]))
    assert abs(d["corona"] - 0.6 * sim) < 1e-6


def test_expand_min_sim_filters():
    idx = _make_index()
    out = idx.expand(["covid"], per_term=5, global_topk=0, min_sim=0.999, alpha=0.6)
    assert out == [("covid", 1.0)]


def test_expand_centroid_factor():
    idx = _make_index()
    out = idx.expand(
        ["covid", "corona"], per_term=0, global_topk=3, min_sim=0.3, alpha=0.6
    )
    d = dict(out)
    # centroid neighbors weighted by 0.8*alpha*sim, originals stay 1.0
    assert d["covid"] == 1.0 and d["corona"] == 1.0
    extra = {t: v for t, v in d.items() if t not in ("covid", "corona")}
    for t, v in extra.items():
        assert v <= 0.8 * 0.6 + 1e-7


def test_expand_cap_total_terms():
    idx = _make_index()
    out = idx.expand(
        ["covid"], per_term=5, global_topk=5, min_sim=-1.0, alpha=0.6,
        max_total_terms=3,
    )
    assert len(out) == 3
    assert out[0] == ("covid", 1.0)
    # sorted by weight desc
    ws = [v for _, v in out]
    assert ws == sorted(ws, reverse=True)


def test_load_from_text(tmp_path):
    p = tmp_path / "emb.vec"
    dim = 12
    rows = []
    rng = np.random.default_rng(3)
    for t in ["alpha", "beta", "gamma"]:
        v = rng.normal(size=dim)
        rows.append(t + " " + " ".join(f"{x:.6f}" for x in v))
    p.write_text(f"3 {dim}\n" + "\n".join(rows) + "\nshort 1 2 3\n")
    idx = SemanticIndex()
    ok = idx.load_from_text(p, {"alpha", "gamma", "short"})
    assert ok and idx.enabled
    assert idx.terms == ["alpha", "gamma"]  # beta filtered, short rejected (<10 dims)
    assert idx.dim == dim
    # vectors normalized
    assert abs(np.linalg.norm(idx._emb_host[0]) - 1.0) < 1e-5


def test_load_missing_file(tmp_path):
    idx = SemanticIndex()
    assert not idx.load_from_text(tmp_path / "nope.vec", set())
    assert not idx.enabled
