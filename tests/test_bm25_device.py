"""Device BM25 kernel parity vs the NumPy oracle (exact f32 scores)."""

import numpy as np
import pytest

from nextsearch.config import DEFAULT_CONFIG, DeviceConfig, EngineConfig
from nextsearch.index.builder import build_segment_arrays
from nextsearch.index.oracle import oracle_search
from nextsearch.index.segment import DeviceIndex

from conftest import make_synthetic_docs


def _queries():
    return [
        [("w0000", 1.0)],  # most common term
        [("w0001", 1.0), ("w0010", 1.0)],
        [("w0002", 1.0), ("w0003", 0.42), ("w0299", 0.6)],  # weighted (expansion-like)
        [("missing", 1.0)],  # no hits
        [("w0050", 1.0), ("w0050", 0.5)],  # duplicate term slots accumulate
    ]


@pytest.fixture(scope="module")
def single_seg():
    docs = make_synthetic_docs(150, 300, seed=2)
    return [build_segment_arrays(docs)]


@pytest.fixture(scope="module")
def multi_seg():
    return [
        build_segment_arrays(make_synthetic_docs(80, 250, seed=3)),
        build_segment_arrays(make_synthetic_docs(120, 250, seed=4, avg_len=40)),
        build_segment_arrays(make_synthetic_docs(30, 250, seed=5, avg_len=90)),
    ]


def _check_parity(segs, mode: str, k: int = 10):
    cfg = EngineConfig(
        device=DeviceConfig(mode=mode, posting_block=64, chunk_buckets=(64, 256, 1024))
    )
    di = DeviceIndex(segs, config=cfg)
    oracle_segs = [s.to_oracle_segment() for s in segs]
    results = di.search_batch(_queries(), k=k)
    for terms, res in zip(_queries(), results):
        hits, total_found = oracle_search(oracle_segs, terms, k=k)
        assert res.found == total_found, terms
        assert len(res.scores) == len(hits), terms
        for (o_score, o_seg, o_doc), d_score, d_slot in zip(hits, res.scores, res.doc_slots):
            seg_idx, doc_id = di.locate(int(d_slot))
            assert (seg_idx, doc_id) == (o_seg, o_doc), terms
            if mode in ("exact", "fused"):
                assert np.float32(d_score) == np.float32(o_score), terms
            else:
                np.testing.assert_allclose(d_score, o_score, rtol=1e-5)


@pytest.mark.parametrize("mode", ["exact", "fused", "fast"])
def test_single_segment_modes(single_seg, mode):
    _check_parity(single_seg, mode)


@pytest.mark.parametrize("mode", ["exact", "fused", "fast"])
def test_multi_segment_modes(multi_seg, mode):
    _check_parity(multi_seg, mode)


def test_fused_k100(multi_seg):
    _check_parity(multi_seg, "fused", k=100)


def test_k_larger_than_matches(single_seg):
    di = DeviceIndex(single_seg)
    # rare term: fewer matches than k -> results truncated to matches
    rare = min(single_seg[0].terms, key=lambda t: single_seg[0].term_df[single_seg[0].term_index(t)])
    res = di.search_batch([[(rare, 1.0)]], k=100)[0]
    assert res.found == len(res.scores)
    assert res.found == int(single_seg[0].term_df[single_seg[0].term_index(rare)])


def test_no_hit_query(single_seg):
    di = DeviceIndex(single_seg)
    res = di.search_batch([[("zzzznotfound", 1.0)]], k=10)[0]
    assert res.found == 0 and len(res.scores) == 0


def test_scores_descending_and_tiebreak(multi_seg):
    di = DeviceIndex(multi_seg)
    res = di.search_batch([[("w0000", 1.0)]], k=32)[0]
    s = res.scores
    assert np.all(np.diff(s) <= 0)
    # equal scores must come in ascending doc-slot order
    for i in range(len(s) - 1):
        if s[i] == s[i + 1]:
            assert res.doc_slots[i] < res.doc_slots[i + 1]


def test_empty_index():
    di = DeviceIndex([])
    res = di.search_batch([[("covid", 1.0)]], k=10)
    assert res[0].found == 0


def test_fused_bf16_scores_parity(multi_seg):
    """bf16 score accumulation: reported scores still bit-exact (rescore)."""
    cfg = EngineConfig(
        device=DeviceConfig(
            mode="fused", posting_block=64, chunk_buckets=(64, 256, 1024),
            scores_bf16=True,
        )
    )
    di = DeviceIndex(multi_seg, config=cfg)
    oracle_segs = [s.to_oracle_segment() for s in multi_seg]
    for terms, res in zip(_queries(), di.search_batch(_queries(), k=10)):
        hits, total_found = oracle_search(oracle_segs, terms, k=10)
        assert res.found == total_found, terms
        assert len(res.scores) == len(hits), terms
        for (o_score, o_seg, o_doc), d_score, d_slot in zip(
            hits, res.scores, res.doc_slots
        ):
            assert di.locate(int(d_slot)) == (o_seg, o_doc), terms
            assert np.float32(d_score) == np.float32(o_score), terms
