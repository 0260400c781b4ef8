"""Semantic query expansion over a device-resident embedding matrix.

Behavioral parity with the reference SemanticIndex
(src/semantic_embedding.cpp):
  - load_from_text parses word2vec/GloVe text format, skipping an optional
    "count dim" header, keeping only needed terms, rejecting rows with < 10
    values or a dim mismatch, and L2-normalizing each vector (norm computed
    in float64 like the reference's double accumulation, :17-24)
  - expand() gives original terms weight 1.0, adds per-term top-`per_term`
    neighbors with weight min(alpha, alpha*sim) (keeping the max on repeats),
    adds centroid top-`global_topk` neighbors at 0.8*alpha*sim, filters
    sim < min_sim, bans rows of the original terms, sorts by weight desc and
    caps at max_total_terms (src/api_engine.cpp:411-417 for the parameters)

Device mechanism: one f32 matmul over the normalized embedding matrix +
masked top-k (ops/dense.py) replaces the O(V*d) scalar scans. The per-term
and centroid queries for one expansion go in a single batched launch.

Ordering note: the reference's output order for equal weights is
std::sort-unspecified; we canonicalize ties as (weight desc, term asc).
Similarities are computed by the device in a different accumulation order than
the C++ scalar loop, so candidates within ~1 ULP of min_sim may differ.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np


class SemanticIndex:
    def __init__(self):
        self.enabled = False
        self.dim = 0
        self.terms: List[str] = []
        self.term_to_row: Dict[str, int] = {}
        self._emb = None  # device f32 [V, d]
        self._emb_host: Optional[np.ndarray] = None

    # ---------------- loading ----------------

    @staticmethod
    def _looks_like_header(line: str) -> bool:
        parts = line.split()
        if len(parts) != 2:
            return False
        try:
            a, b = int(parts[0]), int(parts[1])
        except ValueError:
            return False
        return a > 0 and 0 < b < 5000

    def load_from_text(
        self, path: str | os.PathLike, needed_terms: Set[str]
    ) -> bool:
        self.enabled = False
        self.dim = 0
        self.terms = []
        self.term_to_row = {}
        rows: List[np.ndarray] = []
        try:
            f = open(path, "r", encoding="utf-8", errors="replace")
        except OSError:
            return False
        with f:
            first_line = True
            for line in f:
                line = line.rstrip("\n").rstrip("\r")
                if not line:
                    continue
                if first_line:
                    first_line = False
                    if self._looks_like_header(line):
                        continue
                parts = line.split()
                if not parts:
                    continue
                word = parts[0]
                if needed_terms and word not in needed_terms:
                    continue
                try:
                    v = np.array([float(x) for x in parts[1:]], np.float32)
                except ValueError:
                    continue
                if v.size < 10:
                    continue
                if self.dim == 0:
                    self.dim = int(v.size)
                if v.size != self.dim:
                    continue
                # L2 normalize with float64 norm (reference l2_normalize)
                n = float(np.sqrt(np.sum(v.astype(np.float64) ** 2)))
                if n > 0.0:
                    v = (v.astype(np.float64) / n).astype(np.float32)
                if word in self.term_to_row:
                    continue  # first occurrence wins? ref appends dup rows;
                    # but term_to_row.emplace keeps the first mapping
                self.term_to_row[word] = len(self.terms)
                self.terms.append(word)
                rows.append(v)
        if not rows or self.dim <= 0:
            return False
        self._emb_host = np.stack(rows)
        self._emb = None  # lazily placed on device
        self.enabled = True
        return True

    def load_from_arrays(self, terms: Sequence[str], vectors: np.ndarray) -> bool:
        """Programmatic loader (tests / prebuilt artifacts); normalizes rows."""
        vectors = np.asarray(vectors, np.float32)
        if vectors.ndim != 2 or vectors.shape[0] != len(terms) or len(terms) == 0:
            return False
        norms = np.sqrt(np.sum(vectors.astype(np.float64) ** 2, axis=1))
        norms[norms == 0.0] = 1.0
        self._emb_host = (vectors.astype(np.float64) / norms[:, None]).astype(np.float32)
        self.terms = list(terms)
        self.term_to_row = {t: i for i, t in enumerate(self.terms)}
        self.dim = int(vectors.shape[1])
        self._emb = None
        self.enabled = True
        return True

    @property
    def emb(self):
        import jax.numpy as jnp

        if self._emb is None and self._emb_host is not None:
            self._emb = jnp.asarray(self._emb_host)
        return self._emb

    def get_vec(self, term: str) -> Optional[np.ndarray]:
        row = self.term_to_row.get(term)
        if row is None or self._emb_host is None:
            return None
        return self._emb_host[row]

    # ---------------- expansion ----------------

    def expand(
        self,
        query_terms: Sequence[str],
        per_term: int = 3,
        global_topk: int = 5,
        min_sim: float = 0.55,
        alpha: float = 0.6,
        max_total_terms: int = 40,
    ) -> List[Tuple[str, float]]:
        w: Dict[str, float] = {}
        for t in query_terms:
            if t:
                w[t] = 1.0
        if not self.enabled or self.dim <= 0 or not query_terms:
            return list(w.items())

        from ..ops.dense import similarity_topk

        banned = np.zeros(len(self.terms), bool)
        qrows: List[int] = []
        for t in query_terms:
            row = self.term_to_row.get(t)
            if row is not None:
                banned[row] = True
                qrows.append(row)

        # Batch the per-term vectors and (optionally) the centroid.
        qvecs: List[np.ndarray] = []
        owners: List[str] = []  # "" marks the centroid row
        for t in query_terms:
            v = self.get_vec(t)
            if v is not None:
                qvecs.append(v)
                owners.append(t)
        centroid_k = 0
        if global_topk > 0 and qrows:
            # f32 running sum over query order, then f32 /= cnt, f64-norm
            q = np.zeros(self.dim, np.float32)
            cnt = 0
            for t in query_terms:
                v = self.get_vec(t)
                if v is None:
                    continue
                q += v
                cnt += 1
            if cnt > 0:
                q = q / np.float32(cnt)
                n = float(np.sqrt(np.sum(q.astype(np.float64) ** 2)))
                if n > 0.0:
                    q = (q.astype(np.float64) / n).astype(np.float32)
                qvecs.append(q)
                owners.append("")
                centroid_k = global_topk

        if qvecs:
            import jax.numpy as jnp

            k = max(per_term, centroid_k)
            vals, rows = similarity_topk(
                self.emb,
                jnp.asarray(np.stack(qvecs)),
                jnp.asarray(banned),
                jnp.float32(min_sim),
                k=min(k, len(self.terms)),
            )
            vals = np.asarray(vals)
            rows = np.asarray(rows)
            for qi, owner in enumerate(owners):
                is_centroid = owner == ""
                topk = centroid_k if is_centroid else per_term
                factor = alpha * 0.8 if is_centroid else alpha
                cap = factor
                for j in range(min(topk, vals.shape[1])):
                    sim = float(vals[qi, j])
                    if not np.isfinite(sim):
                        break
                    cand = self.terms[int(rows[qi, j])]
                    weight = max(0.0, min(cap, factor * sim))
                    prev = w.get(cand)
                    if prev is None or weight > prev:
                        w[cand] = weight

        out = sorted(w.items(), key=lambda kv: (-kv[1], kv[0]))
        return out[:max_total_terms]
