"""NumPy reference BM25 scorer — the parity anchor for every device kernel.

This module reproduces the C++ engine's scoring semantics in float32,
operation by operation (reference: src/api_engine.cpp:45-47 for IDF and
:441-496 for the term-at-a-time loop), so that device kernels can be tested for
exact score parity. Accumulation follows the reference's order: terms are
processed in query order and each per-(term,doc) contribution is added to the
running f32 per-doc score.

Tie-break note: the reference's global top-K heap inherits tie order from
unordered_map iteration, which is unspecified. We canonicalize ties as
(score desc, segment index asc, docId asc); device kernels match this by
construction (top_k prefers the lowest flat index).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

F32 = np.float32


def oracle_bm25_idf(N: int, df: int) -> np.float32:
    """f32 BM25 IDF: log(((N - df + 0.5) / (df + 0.5)) + 1) — exact op order.

    The log is the PLATFORM logf (what the C++ engine's std::log(float)
    resolves to); np.log's float32 rounding differs on ~20% of inputs
    (utils/floatops.py).
    """
    from ..utils.floatops import logf_scalar

    num = F32(np.uint32(N) - np.uint32(df)) + F32(0.5)
    den = F32(df) + F32(0.5)
    return logf_scalar(F32(num / den) + F32(1.0))


def oracle_posting_scores(
    N: int,
    avgdl: float,
    df: int,
    tfs: np.ndarray,
    doc_lens: np.ndarray,
    k1: float = 1.2,
    b: float = 0.75,
) -> np.ndarray:
    """Per-posting BM25 contribution (qweight excluded), f32-exact.

    Mirrors src/api_engine.cpp:477-480:
      denom = tf + k1*(1 - b + b*(dl/avgdl));  s = idf * (tf*(k1+1)) / denom
    """
    k1 = F32(k1)
    b = F32(b)
    idf = oracle_bm25_idf(N, df)
    tf_f = tfs.astype(F32)
    dl = doc_lens.astype(F32)
    denom = tf_f + k1 * (F32(1.0) - b + b * (dl / F32(avgdl)))
    return ((idf * (tf_f * (k1 + F32(1.0)))) / denom).astype(F32)


def oracle_search(
    segments: Sequence[dict],
    weighted_terms: Sequence[Tuple[str, float]],
    k: int,
    k1: float = 1.2,
    b: float = 0.75,
) -> Tuple[List[Tuple[float, int, int]], int]:
    """Score `weighted_terms` against in-memory segments; return top-k + found.

    Each segment dict holds:
      N: int, avgdl: float, doc_len: np.ndarray[int],
      postings: dict[str, (doc_ids: np.ndarray, tfs: np.ndarray)]

    Returns ([(score, seg_idx, doc_id)] sorted by (score desc, seg asc, doc
    asc), total_found) where total_found counts matched docs per segment
    summed (reference src/api_engine.cpp:495).
    """
    hits: List[Tuple[float, int, int]] = []
    total_found = 0
    for seg_idx, seg in enumerate(segments):
        score: dict[int, np.float32] = {}
        for term, qweight in weighted_terms:
            entry = seg["postings"].get(term)
            if entry is None:
                continue
            doc_ids, tfs = entry
            df = len(doc_ids)
            if df == 0:
                continue
            doc_lens = seg["doc_len"][doc_ids]
            s = oracle_posting_scores(seg["N"], seg["avgdl"], df, tfs, doc_lens, k1, b)
            qw = F32(qweight)
            for d, sv in zip(doc_ids.tolist(), s):
                score[d] = F32(score.get(d, F32(0.0)) + qw * sv)
        for d, sv in score.items():
            hits.append((float(sv), seg_idx, d))
        total_found += len(score)
    hits.sort(key=lambda h: (-h[0], h[1], h[2]))
    return hits[:k], total_found


def oracle_search_vec(
    segments: Sequence[dict],
    weighted_terms: Sequence[Tuple[str, float]],
    k: int,
    k1: float = 1.2,
    b: float = 0.75,
) -> Tuple[List[Tuple[float, int, int]], int]:
    """oracle_search, vectorized — bit-identical results.

    The scalar oracle's per-posting dict loop costs ~1s for a df-500k
    heavy term; this variant accumulates each term's contributions with
    one fancy-indexed f32 assignment per (segment, term), which performs
    the SAME f32 multiply-then-add per doc in the SAME term order (each
    doc appears once per term), so every score is bit-identical. Used by
    the serving path to rescue fast-path guard trips per QUERY on the
    host (segment.py) — the device-wide exact relaunch kernel cannot
    compile at every shape (the f32 compact table + light bucket table
    of a 16-term 1M-doc envelope exceed HBM), and a host rescue of a few
    queries is cheaper than a whole-batch relaunch.

    Tie handling matches the scalar oracle's canonical (score desc, seg
    asc, doc asc): boundary ties are kept via a >=-threshold cut before
    the exact sort, never split by argpartition order.
    """
    per_seg: List[Tuple[np.ndarray, np.ndarray, int]] = []
    total_found = 0
    for seg_idx, seg in enumerate(segments):
        score = np.zeros(seg["N"], F32)
        for term, qweight in weighted_terms:
            entry = seg["postings"].get(term)
            if entry is None:
                continue
            doc_ids, tfs = entry
            df = len(doc_ids)
            if df == 0:
                continue
            doc_lens = seg["doc_len"][doc_ids]
            s = oracle_posting_scores(
                seg["N"], seg["avgdl"], df, tfs, doc_lens, k1, b
            )
            qw = F32(qweight)
            score[doc_ids] = score[doc_ids] + qw * s
        idx = np.flatnonzero(score > 0)
        total_found += idx.size
        if idx.size > k:
            sv = score[idx]
            thr = np.partition(sv, idx.size - k)[idx.size - k]
            keep = sv >= thr  # keep ALL boundary ties
            idx = idx[keep]
        order = np.lexsort((idx, -score[idx].astype(np.float64)))
        idx = idx[order][: max(k * 4, k)]  # ample tie margin for merge
        per_seg.append((score[idx], idx, seg_idx))
    if not per_seg:
        return [], 0
    scores = np.concatenate([p[0] for p in per_seg])
    docs = np.concatenate([p[1] for p in per_seg])
    segs_arr = np.concatenate(
        [np.full(p[1].shape, p[2], np.int64) for p in per_seg]
    )
    order = np.lexsort((docs, segs_arr, -scores.astype(np.float64)))[:k]
    return (
        [(float(scores[i]), int(segs_arr[i]), int(docs[i])) for i in order],
        total_found,
    )
