"""Dense embedding ops: similarity top-k by matmul.

Replaces the reference's brute-force O(V*d) scalar cosine scans
(src/semantic_embedding.cpp:104-145) with one matmul over the normalized
embedding matrix resident in HBM, plus masked top-k. Also powers the hybrid
retrieval dense rerank (BASELINE config 5).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax


@functools.partial(jax.jit, static_argnames=("k",))
def similarity_topk(
    emb: jax.Array,  # f32 [V, d] L2-normalized embedding matrix
    qvecs: jax.Array,  # f32 [n, d] query vectors (normalized)
    banned: jax.Array,  # bool [V] rows excluded from results
    min_sim: jax.Array,  # f32 scalar similarity floor
    *,
    k: int,
):
    """Per query-vector top-k most similar rows with sim >= min_sim.

    Returns (sims f32 [n, k], rows int32 [n, k]); slots that fail the floor
    or fall in the banned set carry sim = -inf. Ties break toward the lower
    row index (canonical order; reference heap order is first-seen).
    """
    sims = jnp.dot(qvecs, emb.T, preferred_element_type=jnp.float32)  # [n, V]
    neg = jnp.float32(-jnp.inf)
    sims = jnp.where(banned[None, :], neg, sims)
    sims = jnp.where(sims < min_sim, neg, sims)
    vals, rows = lax.top_k(sims, k)
    return vals, rows.astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=())
def matvec_scores(emb: jax.Array, q: jax.Array) -> jax.Array:
    """Similarity of one vector against all rows (f32 matvec)."""
    return jnp.dot(emb, q, preferred_element_type=jnp.float32)


@functools.partial(jax.jit, static_argnames=("K",))
def hybrid_rerank(
    doc_emb: jax.Array,  # f32 [N_pad, d] L2-normalized doc embeddings
    q_emb: jax.Array,  # f32 [Q, d] normalized query embeddings
    cand: jax.Array,  # int32 [Q, C] BM25 candidate doc slots
    bm25: jax.Array,  # f32 [Q, C] BM25 scores (0 = dead slot)
    beta: jax.Array,  # f32 scalar: weight of the (normalized) BM25 term
    *,
    K: int,
):
    """Fused dense rerank of BM25 candidates (BASELINE config 5).

    hybrid = beta * bm25/max_bm25 + (1-beta) * max(cos(q, doc), 0), computed
    on-device: candidate embedding gather + batched dot, then top-K with the
    canonical (score desc, doc slot asc) tie order. Dead candidate slots
    (bm25 <= 0) are excluded. Returns (hybrid f32 [Q,K], doc int32 [Q,K],
    bm25_of_winners f32 [Q,K]).
    """
    alive = bm25 > 0
    gathered = doc_emb[jnp.clip(cand, 0, doc_emb.shape[0] - 1)]  # [Q, C, d]
    cos = jnp.einsum(
        "qd,qcd->qc", q_emb, gathered, preferred_element_type=jnp.float32
    )
    cos = jnp.maximum(cos, 0.0)
    denom = jnp.maximum(jnp.max(bm25, axis=1, keepdims=True), 1e-30)
    hybrid = beta * (bm25 / denom) + (jnp.float32(1.0) - beta) * cos
    neg = jnp.where(alive, -hybrid, jnp.float32(jnp.inf))
    sort_doc = jnp.where(alive, cand, jnp.int32(2**30))
    skey, sdoc, sval, sbm = lax.sort((neg, sort_doc, hybrid, bm25), num_keys=2)
    k = min(K, cand.shape[1])
    return sval[:, :k], sdoc[:, :k].astype(jnp.int32), sbm[:, :k]
