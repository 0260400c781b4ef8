"""Vectorized index build pipeline: documents -> segment arrays.

The reference builds a segment with two CLI passes (src/ForwardIndex.cpp:54-233
then src/lexicon.cpp:16-152) writing per-term posting byte-streams. Here a
segment is a set of flat arrays designed for the device query kernels:

  terms        sorted (lexicographic) unique term strings
  term_df      int32[T]   document frequency per term
  term_offsets int64[T+1] CSR offsets into the posting arrays
  post_doc     int32[P]   docId per posting (ascending within each term)
  post_tf      int32[P]   term frequency per posting
  post_score   f32[P]     optional precomputed BM25 contribution ("eager"
                          scoring: the (tf, dl, df, N, avgdl)-only part of the
                          BM25 formula is known at build time, so query time is
                          reduced to gather + weighted accumulate + top-k)
  doc_len      int32[N], N, avgdl, cord_uids/titles/relpaths

Terms are stored sorted so the device autocomplete/prefix kernels can binary
search them; `legacy_ids` preserves the reference's first-encounter termId
order for exporting reference-compatible segment files (segmentio.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.textutil import tokenize, STOPWORDS
from .oracle import F32

__all__ = ["SegmentArrays", "build_segment_arrays", "eager_scores"]


@dataclass
class SegmentArrays:
    """Host-side arrays for one immutable index segment."""

    terms: List[str]
    term_df: np.ndarray  # int32 [T]
    term_offsets: np.ndarray  # int64 [T+1]
    post_doc: np.ndarray  # int32 [P]
    post_tf: np.ndarray  # int32 [P]
    doc_len: np.ndarray  # int32 [N]
    N: int
    avgdl: float
    cord_uids: List[str]
    titles: List[str] = field(default_factory=list)
    relpaths: List[str] = field(default_factory=list)
    # first-encounter termId per sorted term (reference termId order)
    legacy_ids: Optional[np.ndarray] = None  # int32 [T]
    post_score: Optional[np.ndarray] = None  # f32 [P]

    _term_to_idx: Optional[Dict[str, int]] = None

    @property
    def num_terms(self) -> int:
        return len(self.terms)

    @property
    def num_postings(self) -> int:
        return int(self.post_doc.shape[0])

    def term_index(self, term: str) -> int:
        """Sorted-table index of `term`, or -1."""
        if self._term_to_idx is None:
            self._term_to_idx = {t: i for i, t in enumerate(self.terms)}
        return self._term_to_idx.get(term, -1)

    def postings(self, term: str) -> Tuple[np.ndarray, np.ndarray]:
        i = self.term_index(term)
        if i < 0:
            return np.empty(0, np.int32), np.empty(0, np.int32)
        lo, hi = int(self.term_offsets[i]), int(self.term_offsets[i + 1])
        return self.post_doc[lo:hi], self.post_tf[lo:hi]

    def to_oracle_segment(self) -> dict:
        """View as the oracle's in-memory segment dict (tests/parity)."""
        postings = {}
        for i, t in enumerate(self.terms):
            lo, hi = int(self.term_offsets[i]), int(self.term_offsets[i + 1])
            postings[t] = (self.post_doc[lo:hi], self.post_tf[lo:hi])
        return {
            "N": self.N,
            "avgdl": self.avgdl,
            "doc_len": self.doc_len,
            "postings": postings,
        }


def _doc_tf(tokens: Iterable[str]) -> Tuple[Dict[str, int], int]:
    """Term-frequency map + doc_len with the reference's filter applied."""
    tf: Dict[str, int] = {}
    doc_len = 0
    for t in tokens:
        if len(t) < 2 or t in STOPWORDS:
            continue
        tf[t] = tf.get(t, 0) + 1
        doc_len += 1
    return tf, doc_len


def build_segment_arrays(
    docs: Iterable[dict],
    k1: float = 1.2,
    b: float = 0.75,
    with_scores: bool = True,
    use_native: Optional[bool] = None,
) -> SegmentArrays:
    """Build a segment from an iterable of documents.

    Each doc dict needs "cord_uid" and either "text" (tokenized here) or
    "tokens" (pre-tokenized, unfiltered); "title"/"relpath" are optional.
    Documents producing zero kept tokens are skipped (ForwardIndex.cpp:153).

    use_native: True/False forces the C++ builder (nextsearch.native) or
    the Python path; None auto-selects native when the library is available.
    Both produce identical arrays (tests/test_native.py).
    """
    docs = list(docs)
    if use_native is not False:
        from .. import native

        # The native builder tokenizes raw text; pre-tokenized docs must
        # take the Python path, since re-joining tokens would re-split any
        # token with non-alphanumeric characters (e.g. 'covid-19') and
        # break the 'identical arrays' contract.
        all_text = all(doc.get("text") is not None for doc in docs)
        if native.available() and all_text:
            try:
                return _build_native(docs, k1, b, with_scores)
            except (OSError, AssertionError):
                if use_native:
                    raise
    term_to_legacy: Dict[str, int] = {}
    legacy_terms: List[str] = []

    cord_uids: List[str] = []
    titles: List[str] = []
    relpaths: List[str] = []
    doc_lens: List[int] = []

    # flat (legacy_tid, tf) per doc, plus per-doc counts
    flat_tids: List[np.ndarray] = []
    flat_tfs: List[np.ndarray] = []
    flat_docs: List[np.ndarray] = []

    total_len = 0
    for doc in docs:
        tokens = doc.get("tokens")
        if tokens is None:
            tokens = tokenize(doc.get("text", ""))
        tf, doc_len = _doc_tf(tokens)
        if doc_len == 0:
            continue
        doc_id = len(cord_uids)
        cord_uids.append(doc["cord_uid"])
        titles.append(doc.get("title", ""))
        relpaths.append(doc.get("relpath", ""))
        doc_lens.append(doc_len)
        total_len += doc_len

        tids = np.empty(len(tf), np.int32)
        tfs = np.empty(len(tf), np.int32)
        for j, (term, cnt) in enumerate(tf.items()):
            tid = term_to_legacy.get(term)
            if tid is None:
                tid = len(legacy_terms)
                term_to_legacy[term] = tid
                legacy_terms.append(term)
            tids[j] = tid
            tfs[j] = cnt
        flat_tids.append(tids)
        flat_tfs.append(tfs)
        flat_docs.append(np.full(len(tf), doc_id, np.int32))

    N = len(cord_uids)
    # f32 division mirrors ForwardIndex.cpp:186
    avgdl = float(F32(total_len) / F32(N)) if N else 0.0

    T = len(legacy_terms)
    if T == 0:
        empty_i32 = np.empty(0, np.int32)
        return SegmentArrays(
            terms=[], term_df=empty_i32, term_offsets=np.zeros(1, np.int64),
            post_doc=empty_i32, post_tf=empty_i32,
            doc_len=np.asarray(doc_lens, np.int32), N=N, avgdl=avgdl,
            cord_uids=cord_uids, titles=titles, relpaths=relpaths,
            legacy_ids=empty_i32,
            post_score=np.empty(0, F32) if with_scores else None,
        )

    all_tids = np.concatenate(flat_tids) if flat_tids else np.empty(0, np.int32)
    all_tfs = np.concatenate(flat_tfs) if flat_tfs else np.empty(0, np.int32)
    all_docs = np.concatenate(flat_docs) if flat_docs else np.empty(0, np.int32)

    # Sorted term table; rank[legacy_tid] = sorted index.
    sort_order = np.argsort(np.asarray(legacy_terms, dtype=object), kind="stable")
    terms = [legacy_terms[i] for i in sort_order]
    rank = np.empty(T, np.int64)
    rank[sort_order] = np.arange(T)

    # Invert: stable sort by sorted-term rank keeps ascending doc order
    # within each term (docs were appended in increasing docId order).
    post_rank = rank[all_tids]
    order = np.argsort(post_rank, kind="stable")
    post_doc = all_docs[order]
    post_tf = all_tfs[order]

    term_df = np.bincount(post_rank, minlength=T).astype(np.int32)
    term_offsets = np.zeros(T + 1, np.int64)
    np.cumsum(term_df, out=term_offsets[1:])

    seg = SegmentArrays(
        terms=terms,
        term_df=term_df,
        term_offsets=term_offsets,
        post_doc=post_doc.astype(np.int32),
        post_tf=post_tf.astype(np.int32),
        doc_len=np.asarray(doc_lens, np.int32),
        N=N,
        avgdl=avgdl,
        cord_uids=cord_uids,
        titles=titles,
        relpaths=relpaths,
        legacy_ids=np.asarray(sort_order, np.int32),
    )
    if with_scores:
        seg.post_score = eager_scores(seg, k1=k1, b=b)
    return seg


def _build_native(docs, k1, b, with_scores) -> SegmentArrays:
    """C++ fast path of build_segment_arrays (identical output)."""
    from .. import native

    builder = native.NativeForwardBuilder()
    cord_uids: List[str] = []
    titles: List[str] = []
    relpaths: List[str] = []
    try:
        for doc in docs:
            text = doc.get("text")
            if text is None:
                text = " ".join(doc.get("tokens", ()))
            dl = builder.add_doc(text)
            if dl == 0:
                continue
            cord_uids.append(doc["cord_uid"])
            titles.append(doc.get("title", ""))
            relpaths.append(doc.get("relpath", ""))
        (
            terms, legacy_ids, term_df, term_offsets,
            post_doc, post_tf, doc_len, total_len,
        ) = builder.finish()
    finally:
        builder.close()

    N = len(cord_uids)
    assert N == doc_len.shape[0]
    avgdl = float(F32(total_len) / F32(N)) if N else 0.0
    seg = SegmentArrays(
        terms=terms,
        term_df=term_df if terms else np.empty(0, np.int32),
        term_offsets=term_offsets,
        post_doc=post_doc if terms else np.empty(0, np.int32),
        post_tf=post_tf if terms else np.empty(0, np.int32),
        doc_len=doc_len[:N],
        N=N,
        avgdl=avgdl,
        cord_uids=cord_uids,
        titles=titles,
        relpaths=relpaths,
        legacy_ids=legacy_ids if terms else np.empty(0, np.int32),
    )
    if with_scores:
        seg.post_score = eager_scores(seg, k1=k1, b=b)
    return seg


def eager_scores(seg: SegmentArrays, k1: float = 1.2, b: float = 0.75) -> np.ndarray:
    """Precompute the per-posting BM25 contribution in f32.

    Vectorized form of src/api_engine.cpp:461,477-480: at query time the only
    remaining work is `score[doc] += qweight * post_score[p]`.
    """
    if seg.num_postings == 0:
        return np.empty(0, F32)
    k1 = F32(k1)
    b = F32(b)
    # IDF per term, broadcast to postings. Exact op order of bm25_idf,
    # including the platform logf (std::log(float) in the reference; np.log's
    # f32 rounding differs on ~20% of inputs — utils/floatops.py).
    from ..utils.floatops import logf_exact

    n_minus_df = (np.uint32(seg.N) - seg.term_df.astype(np.uint32)).astype(F32)
    idf_t = logf_exact(
        (n_minus_df + F32(0.5)) / (seg.term_df.astype(F32) + F32(0.5)) + F32(1.0)
    )
    df_counts = np.diff(seg.term_offsets)
    idf_p = np.repeat(idf_t, df_counts)

    tf_f = seg.post_tf.astype(F32)
    dl = seg.doc_len.astype(F32)[seg.post_doc]
    denom = tf_f + k1 * (F32(1.0) - b + b * (dl / F32(seg.avgdl)))
    return ((idf_p * (tf_f * (k1 + F32(1.0)))) / denom).astype(F32)
