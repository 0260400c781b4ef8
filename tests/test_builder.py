"""Index build pipeline invariants (mirrors src/lexicon.cpp:104-128 checks)."""

import numpy as np

from nextsearch.index.builder import build_segment_arrays, eager_scores
from nextsearch.index.oracle import oracle_posting_scores


def _docs():
    return [
        {"cord_uid": "u0", "text": "covid vaccine trial covid"},
        {"cord_uid": "u1", "text": "vaccine efficacy study"},
        {"cord_uid": "u2", "text": "the a an of to"},  # all stopwords -> skipped
        {"cord_uid": "u3", "text": "covid study outcomes"},
    ]


def test_build_basic_invariants():
    seg = build_segment_arrays(_docs())
    # u2 is skipped entirely (zero kept tokens)
    assert seg.N == 3
    assert seg.cord_uids == ["u0", "u1", "u3"]
    # doc_len counts kept tokens including repeats
    assert seg.doc_len.tolist() == [4, 3, 3]
    # avgdl in f32
    assert abs(seg.avgdl - 10.0 / 3.0) < 1e-6

    # terms sorted lexicographically
    assert seg.terms == sorted(seg.terms)
    # df == postings count per term (lexicon.cpp: count==df invariant)
    assert np.array_equal(np.diff(seg.term_offsets), seg.term_df)

    # postings sorted by docId within each term
    for i in range(seg.num_terms):
        lo, hi = int(seg.term_offsets[i]), int(seg.term_offsets[i + 1])
        d = seg.post_doc[lo:hi]
        assert np.all(np.diff(d) > 0)

    # spot-check: covid appears in docs 0 and 2 with tf 2,1
    docs, tfs = seg.postings("covid")
    assert docs.tolist() == [0, 2]
    assert tfs.tolist() == [2, 1]


def test_legacy_ids_first_encounter_order():
    seg = build_segment_arrays(_docs())
    # legacy_ids maps sorted index -> first-encounter id; inverse must cover 0..T-1
    assert sorted(seg.legacy_ids.tolist()) == list(range(seg.num_terms))
    # 'covid' was the first term encountered in doc u0
    i = seg.term_index("covid")
    assert seg.legacy_ids[i] == 0


def test_eager_scores_match_oracle_per_term(synthetic_docs):
    seg = build_segment_arrays(synthetic_docs)
    assert seg.post_score is not None
    for term in seg.terms[:: max(1, seg.num_terms // 37)]:
        i = seg.term_index(term)
        lo, hi = int(seg.term_offsets[i]), int(seg.term_offsets[i + 1])
        docs = seg.post_doc[lo:hi]
        tfs = seg.post_tf[lo:hi]
        expected = oracle_posting_scores(
            seg.N, seg.avgdl, int(seg.term_df[i]), tfs, seg.doc_len[docs]
        )
        got = seg.post_score[lo:hi]
        assert np.array_equal(got, expected), term


def test_empty_corpus():
    seg = build_segment_arrays([])
    assert seg.N == 0 and seg.num_terms == 0 and seg.num_postings == 0
