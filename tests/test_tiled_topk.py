"""tiled_topk exactness vs lax.top_k, including adversarial ties."""

import numpy as np
import pytest

import jax.numpy as jnp
from jax import lax

from nextsearch.ops.bm25 import tiled_topk


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matches_flat_topk_random(seed):
    rng = np.random.default_rng(seed)
    Q, NS, k2 = 4, 64 * 2048, 32  # NS big enough to trigger the tiled path
    scores = rng.random((Q, NS)).astype(np.float32)
    scores[scores < 0.7] = 0.0  # sparsity like real score vectors
    v1, i1 = tiled_topk(jnp.asarray(scores), k2, tile=2048)
    v2, i2 = lax.top_k(jnp.asarray(scores), k2)
    assert np.array_equal(np.asarray(v1), np.asarray(v2))
    assert np.array_equal(np.asarray(i1), np.asarray(i2))


def test_ties_break_by_slot_asc():
    Q, NS, k2 = 1, 64 * 2048, 8
    scores = np.zeros((Q, NS), np.float32)
    # 20 identical scores scattered across far-apart tiles
    pos = np.arange(20) * 5000 + 17
    scores[0, pos] = 0.5
    v1, i1 = tiled_topk(jnp.asarray(scores), k2, tile=2048)
    v2, i2 = lax.top_k(jnp.asarray(scores), k2)
    assert np.array_equal(np.asarray(i1), np.asarray(i2))
    assert np.asarray(i1)[0].tolist() == pos[:k2].tolist()


def test_small_ns_falls_back():
    scores = np.random.default_rng(0).random((2, 1000)).astype(np.float32)
    v1, i1 = tiled_topk(jnp.asarray(scores), 10)
    v2, i2 = lax.top_k(jnp.asarray(scores), 10)
    assert np.array_equal(np.asarray(v1), np.asarray(v2))


def test_cluster_in_one_tile():
    # all top values inside a single tile (stress the k2-tile sufficiency)
    Q, NS, k2 = 1, 64 * 2048, 16
    scores = np.zeros((Q, NS), np.float32)
    scores[0, 4096:4096 + 50] = np.linspace(1.0, 0.5, 50, dtype=np.float32)
    v1, i1 = tiled_topk(jnp.asarray(scores), k2, tile=2048)
    v2, i2 = lax.top_k(jnp.asarray(scores), k2)
    assert np.array_equal(np.asarray(i1), np.asarray(i2))
