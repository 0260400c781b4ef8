"""Hybrid retrieval: BM25 candidate generation + dense rerank on device.

BASELINE config 5 ("BM25 candidates + semantic_embedding dense rerank fused
on the accelerator"). The reference has no document embeddings; we derive them at build
time as the tf-weighted mean of each document's term embeddings (terms the
SemanticIndex knows), L2-normalized — the classic fastText-style doc vector.
Query embeddings use the same construction over the weighted query terms.

Final score: beta * bm25/max_bm25(query) + (1-beta) * max(cos, 0), reranked
entirely on device (ops/dense.hybrid_rerank).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..index.builder import SegmentArrays
from ..index.segment import QueryResult, WeightedTerm
from .semantic import SemanticIndex


def _emb_scatter_chunk(doc_emb, emb, docs, rows, tfs):
    """One fixed-size chunk of the doc-embedding scatter (jitted, donated:
    the accumulator updates in place across chunks)."""
    vecs = emb[rows] * tfs[:, None]
    return doc_emb.at[docs].add(vecs)


def _emb_normalize(doc_emb):
    import jax.numpy as jnp

    norms = jnp.sqrt(jnp.sum(doc_emb * doc_emb, axis=1, keepdims=True))
    return doc_emb / jnp.where(norms == 0.0, jnp.float32(1.0), norms)


_jit_cache: dict = {}


def _jitted(name, fn):
    """Module-level jit wrappers (jax imported lazily, traced once)."""
    f = _jit_cache.get(name)
    if f is None:
        import jax

        f = jax.jit(fn, donate_argnums=(0,))
        _jit_cache[name] = f
    return f


class HybridIndex:
    """Doc-embedding store + fused rerank over a BM25 index's candidates.

    `index` is a DeviceIndex or a ShardedIndex — anything providing the
    common index interface (slot_capacity, segment_slot_bases,
    search_batch_async/gather).
    """

    def __init__(
        self,
        index,
        sem: SemanticIndex,
        beta: float = 0.5,
        chunk: int = 262144,
    ):
        import jax
        import jax.numpy as jnp

        assert sem.enabled, "hybrid rerank needs a loaded SemanticIndex"
        self.index = index
        self.sem = sem
        self.beta = float(beta)
        d = sem.dim

        # Build doc embeddings: scatter tf-weighted term vectors per doc.
        # slot_capacity / segment_slot_bases are the common index interface —
        # works for both DeviceIndex (contiguous slots) and ShardedIndex
        # (shard-major global slots).
        #
        # Default path builds ON DEVICE: the host never materializes the
        # [n_slots, d] matrix (1.2 GB at 1M slots x 300 dims, plus its
        # upload);
        # only the per-posting (doc, term-row, tf) triples stream up in
        # fixed-size chunks and the scatter-add + L2 normalize run on the
        # accumulator in place.
        n_slots = index.slot_capacity
        device_build = (
            os.environ.get("NEXTSEARCH_HYBRID_DEVICE_BUILD", "1") == "1"
        )
        if device_build:
            scatter = _jitted("scatter", _emb_scatter_chunk)
            emb = jnp.asarray(sem._emb_host)
            doc_emb = jnp.zeros((n_slots, d), jnp.float32)
            CH = max(int(chunk), 1)
            for seg, dbase in zip(index.segments, index.segment_slot_bases()):
                rows = np.array(
                    [sem.term_to_row.get(t, -1) for t in seg.terms], np.int64
                )
                row_per_post = np.repeat(rows, np.diff(seg.term_offsets))
                known = row_per_post >= 0
                docs = (
                    seg.post_doc[known].astype(np.int64) + dbase
                ).astype(np.int32)
                tfs = seg.post_tf[known].astype(np.float32)
                rws = row_per_post[known].astype(np.int32)
                for lo in range(0, docs.shape[0], CH):
                    hi = min(lo + CH, docs.shape[0])
                    pad = CH - (hi - lo)
                    # zero-tf padding scatters a zero vector: a no-op add
                    dck = np.pad(docs[lo:hi], (0, pad))
                    rck = np.pad(rws[lo:hi], (0, pad))
                    tck = np.pad(tfs[lo:hi], (0, pad))
                    doc_emb = scatter(
                        doc_emb, emb, jnp.asarray(dck), jnp.asarray(rck),
                        jnp.asarray(tck),
                    )
            self.doc_emb = _jitted("normalize", _emb_normalize)(doc_emb)
        else:
            emb_host = sem._emb_host
            doc_emb = np.zeros((n_slots, d), np.float32)
            for seg, dbase in zip(index.segments, index.segment_slot_bases()):
                rows = np.array(
                    [sem.term_to_row.get(t, -1) for t in seg.terms], np.int64
                )
                row_per_post = np.repeat(rows, np.diff(seg.term_offsets))
                known = row_per_post >= 0
                docs = seg.post_doc[known].astype(np.int64) + dbase
                tfs = seg.post_tf[known].astype(np.float32)
                vecs = emb_host[row_per_post[known]]
                np.add.at(doc_emb, docs, vecs * tfs[:, None])
            norms = np.linalg.norm(doc_emb, axis=1)
            norms[norms == 0.0] = 1.0
            doc_emb /= norms[:, None]
            self.doc_emb = jnp.asarray(doc_emb)

    def query_embedding(self, terms: Sequence[WeightedTerm]) -> np.ndarray:
        d = self.sem.dim
        q = np.zeros(d, np.float32)
        for t, w in terms:
            v = self.sem.get_vec(t)
            if v is not None:
                q += np.float32(w) * v
        n = float(np.linalg.norm(q))
        if n > 0:
            q = q / np.float32(n)
        return q

    def search_batch_async(
        self,
        queries: Sequence[Sequence[WeightedTerm]],
        k: int,
        candidates: int = 100,
    ):
        """Launch BM25 top-`candidates` + fused dense rerank; no host sync.

        The BM25 handle's device arrays feed hybrid_rerank directly —
        nothing round-trips through the host — so callers can pipeline
        hybrid launches exactly like DeviceIndex.search_batch_async."""
        import jax.numpy as jnp

        from ..ops.dense import hybrid_rerank

        nq = len(queries)
        if nq == 0 or self.index.n_docs == 0:
            return ("hybrid_trivial", nq)

        C = max(candidates, k)
        sparse_direct = getattr(self.index, "_sparse", False) and hasattr(
            self.index, "doc_bases"
        )
        # sparse DeviceIndex: the rerank chains on the packed device
        # array with no host round trip (the old path gathered BM25 on
        # the host and relaunched the rerank synchronously: one host
        # round trip per batch, unpipelineable). Host-shortcut rows
        # (1-term head-heavy fills, which would otherwise send df~N
        # queries to the device at the K2-wide rescore) merge into the
        # same rerank launch as a small uploaded candidate matrix.
        handle = self.index.search_batch_async(queries, C)
        if handle[0] == "empty":
            return ("hybrid_passthrough", handle)
        perm = None
        guard = None
        fills = None
        bm_queries = queries
        if handle[0] == "packed" and len(handle) == 5:
            # fused-mode packed launch: rerank straight off the device
            # result array, nothing round-trips through the host
            _tag, _nq, _k, K, out_arr = handle
            vals = out_arr[:, :K]
            # ids packed as exact f32 values (never denormal bitcasts)
            idx = out_arr[:, K : 2 * K].astype(jnp.int32)
            found = out_arr[:, 2 * K].astype(jnp.int32)
        elif handle[0] == "pending":
            _tag, _nq, _k, K, vals, idx, found = handle
        elif sparse_direct and handle[0] == "fills":
            # whole batch answered host-side: rerank the fill candidates
            # in one launch (no BM25 launch happened)
            _tag, _nq, _k, fills_all = handle
            K = C
            vals, idx, found = self._fill_arrays(fills_all, nq, C, None)
            vals = jnp.asarray(vals)
            idx = jnp.asarray(idx)
            found = jnp.asarray(found)
        elif sparse_direct and handle[0] in ("packed", "packedg"):
            if handle[0] == "packedg":
                _tag, _nq, _k, K, dev_out = handle[:5]
                perm = handle[6]
                fills = handle[8] if len(handle) > 8 else None
                guard = dev_out[:, 2 * K + 1]
            else:
                _tag, _nq, _k, K, dev_out = handle[:5]
                perm = handle[5] if len(handle) > 5 else None
                fills = handle[6] if len(handle) > 6 else None
            vals = dev_out[:, :K]
            idx = dev_out[:, K : 2 * K].astype(jnp.int32)
            found = dev_out[:, 2 * K].astype(jnp.int32)
            if perm is not None:
                bm_queries = [queries[perm[j]] for j in range(nq)]
            if fills:
                # splice host-shortcut rows into the device candidates
                # (row j in launch space answers original index perm[j];
                # rows past the live query count are envelope padding)
                Qb = int(vals.shape[0])
                n_live = min(Qb, len(perm) if perm is not None else nq)
                f_vals, f_idx, f_found = self._fill_arrays(
                    fills, Qb, min(C, K), perm, n_live
                )
                mask = np.zeros((Qb, 1), bool)
                rows = [
                    j for j in range(n_live)
                    if (int(perm[j]) if perm is not None else j) in fills
                ]
                mask[rows] = True
                mask_d = jnp.asarray(mask)
                pad = K - f_vals.shape[1]
                if pad:
                    f_vals = np.pad(f_vals, ((0, 0), (0, pad)))
                    f_idx = np.pad(
                        f_idx, ((0, 0), (0, pad)), constant_values=2**30
                    )
                vals = jnp.where(mask_d, jnp.asarray(f_vals), vals)
                idx = jnp.where(mask_d, jnp.asarray(f_idx), idx)
                found = jnp.where(
                    mask_d[:, 0], jnp.asarray(f_found), found
                )
        else:
            # sharded / unknown handles still gather host-side
            q_emb = np.stack([self.query_embedding(q) for q in queries])
            return ("hybrid_host", nq, k, C, handle, q_emb)

        q_emb = np.stack([self.query_embedding(q) for q in bm_queries])
        Qb = vals.shape[0]
        if q_emb.shape[0] < Qb:
            q_emb = np.vstack(
                [q_emb, np.zeros((Qb - q_emb.shape[0], self.sem.dim), np.float32)]
            )

        hvals, hdocs, hbm25 = hybrid_rerank(
            self.doc_emb, jnp.asarray(q_emb), idx, vals,
            jnp.float32(self.beta), K=min(k, K),
        )
        for a in (hvals, hdocs, hbm25, found):
            a.copy_to_host_async()
        if guard is not None:
            guard.copy_to_host_async()
        return (
            "hybrid", nq, k, hvals, hdocs, hbm25, found, perm, guard,
            queries, C,
        )

    def _fill_arrays(self, fills, rows, C, perm, n_live=None):
        """Host-shortcut QueryResults -> padded (vals, idx, found) arrays
        in LAUNCH row space (row j answers original index perm[j]; rows
        past n_live are envelope padding)."""
        vals = np.zeros((rows, C), np.float32)
        idx = np.full((rows, C), 2**30, np.int32)
        found = np.zeros(rows, np.int32)
        for j in range(rows if n_live is None else n_live):
            orig = int(perm[j]) if perm is not None else j
            qr = fills.get(orig)
            if qr is None:
                continue
            n = min(len(qr.scores), C)
            vals[j, :n] = qr.scores[:n]
            idx[j, :n] = qr.doc_slots[:n]
            found[j] = qr.found
        return vals, idx, found

    def search_batch_gather(self, handle) -> List[QueryResult]:
        """Block on a search_batch_async handle and assemble results."""
        import jax

        if handle[0] == "hybrid_trivial":
            return [
                QueryResult(np.empty(0, np.float32), np.empty(0, np.int32), 0)
            ] * handle[1]
        if handle[0] == "hybrid_passthrough":
            return self.index.search_batch_gather(handle[1])
        if handle[0] == "hybrid_host":
            import jax.numpy as jnp

            from ..ops.dense import hybrid_rerank

            _tag, nq, k, C, bm_handle, q_emb = handle
            base = self.index.search_batch_gather(bm_handle)
            vals_h = np.zeros((nq, C), np.float32)
            idx_h = np.zeros((nq, C), np.int32)
            found_h = np.array([r.found for r in base], np.int32)
            for qi, r in enumerate(base):
                n = min(len(r.scores), C)
                vals_h[qi, :n] = r.scores[:n]
                idx_h[qi, :n] = r.doc_slots[:n]
            hvals, hdocs, hbm25 = hybrid_rerank(
                self.doc_emb, jnp.asarray(q_emb), jnp.asarray(idx_h),
                jnp.asarray(vals_h), jnp.float32(self.beta), K=min(k, C),
            )
            handle = ("hybrid", nq, k, hvals, hdocs, hbm25,
                      jnp.asarray(found_h))
        _tag, nq, k, hvals, hdocs, hbm25, found = handle[:7]
        perm = handle[7] if len(handle) > 7 else None
        guard = handle[8] if len(handle) > 8 else None
        orig_queries = handle[9] if len(handle) > 9 else None
        C = handle[10] if len(handle) > 10 else hdocs.shape[1]
        if guard is not None:
            hvals, hdocs, hbm25, found, guard = jax.device_get(
                (hvals, hdocs, hbm25, found, guard)
            )
        else:
            hvals, hdocs, hbm25, found = jax.device_get(
                (hvals, hdocs, hbm25, found)
            )

        out: List[Optional[QueryResult]] = [None] * nq
        for qi in range(nq):
            pos = int(perm[qi]) if perm is not None else qi
            if (
                guard is not None
                and guard[qi] < 0.5
                and orig_queries is not None
            ):
                # BM25 guard tripped for this row: the fast candidates may
                # be inexact — recompute exactly host-side (rare)
                out[pos] = self._host_hybrid_row(orig_queries[pos], k, C)
                continue
            keep = hbm25[qi] > 0.0
            out[pos] = QueryResult(
                scores=hvals[qi][keep][:k],
                doc_slots=hdocs[qi][keep][:k],
                found=int(found[qi]),
            )
        return out  # type: ignore[return-value]

    def _host_hybrid_row(self, query, k: int, C: int) -> QueryResult:
        """Exact hybrid result for one query: host-oracle BM25 top-C +
        the rerank formula over device-gathered candidate embeddings
        (guard-trip fix-up; also the parity oracle for config 5)."""
        import jax.numpy as jnp

        from ..index.oracle import oracle_search_vec

        bm = self.index.config.bm25
        hits, found = oracle_search_vec(
            self.index._oracle_segs(), query, C, k1=bm.k1, b=bm.b,
        )
        if not hits:
            return QueryResult(
                np.empty(0, np.float32), np.empty(0, np.int32), int(found)
            )
        bases = self.index.doc_bases
        cand = np.asarray(
            [bases[seg] + doc for _s, seg, doc in hits], np.int32
        )
        bm25 = np.asarray([s for s, _seg, _doc in hits], np.float32)
        q_emb = self.query_embedding(query)
        emb = np.asarray(self.doc_emb[jnp.asarray(cand)], np.float32)
        cos = np.maximum(emb @ q_emb.astype(np.float32), 0.0)
        denom = max(float(bm25.max()), 1e-30)
        hybrid = (
            np.float32(self.beta) * (bm25 / np.float32(denom))
            + np.float32(1.0 - self.beta) * cos.astype(np.float32)
        )
        order = np.lexsort((cand, -hybrid))
        order = order[bm25[order] > 0][:k]
        return QueryResult(
            scores=hybrid[order].astype(np.float32),
            doc_slots=cand[order],
            found=int(found),
        )

    def search_batch(
        self,
        queries: Sequence[Sequence[WeightedTerm]],
        k: int,
        candidates: int = 100,
    ) -> List[QueryResult]:
        """BM25 top-`candidates` then fused dense rerank to top-k."""
        return self.search_batch_gather(
            self.search_batch_async(queries, k, candidates)
        )
