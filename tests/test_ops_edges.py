"""Edge-case tests for the kernel building blocks."""

import numpy as np

import jax.numpy as jnp

from nextsearch.ops.bm25 import (
    canonical_sort,
    exact_rescore,
    expand_chunks,
    heavy_scores,
)


def test_expand_chunks_empty_plan():
    starts = jnp.zeros((2, 4), jnp.int32)
    dfs = jnp.zeros((2, 4), jnp.int32)
    w = jnp.zeros((2, 4), jnp.float32)
    cs, cl, cq, cw = expand_chunks(starts, dfs, w, C=16, block=8)
    assert np.all(np.asarray(cl) == 0)
    assert np.all(np.asarray(cq) == 2)  # all dropped


def test_expand_chunks_exact_boundaries():
    # df exactly equal to block, one more, one less
    starts = jnp.asarray([[0, 100, 200, 0]], jnp.int32)
    dfs = jnp.asarray([[8, 9, 7, 0]], jnp.int32)
    w = jnp.asarray([[1.0, 1.0, 1.0, 0.0]], jnp.float32)
    cs, cl, cq, cw = expand_chunks(starts, dfs, w, C=8, block=8)
    cs, cl, cq = np.asarray(cs), np.asarray(cl), np.asarray(cq)
    live = cl > 0
    # 1 + 2 + 1 = 4 chunks
    assert live.sum() == 4
    assert sorted(cl[live].tolist()) == [1, 7, 8, 8]
    assert np.all(cq[live] == 0)


def test_canonical_sort_all_dead():
    scores = jnp.zeros((2, 5), jnp.float32)
    docs = jnp.arange(10, dtype=jnp.int32).reshape(2, 5)
    v, d = canonical_sort(scores, docs)
    assert np.all(np.asarray(v) == 0)
    assert np.all(np.asarray(d) == 2**30)


def test_exact_rescore_candidate_not_in_postings():
    post_doc = jnp.asarray([2, 5, 9], jnp.int32)
    post_score = jnp.asarray([1.0, 2.0, 3.0], jnp.float32)
    starts = jnp.asarray([[0]], jnp.int32)
    dfs = jnp.asarray([[3]], jnp.int32)
    w = jnp.asarray([[1.0]], jnp.float32)
    cand = jnp.asarray([[5, 4, 9, 11]], jnp.int32)
    out = np.asarray(
        exact_rescore(post_doc, post_score, starts, dfs, w, cand, bs_steps=8)
    )
    assert out.tolist() == [[2.0, 0.0, 3.0, 0.0]]


def test_heavy_scores_zero_padding_row():
    dense = jnp.asarray(
        [[1.0, 0.0, 2.0], [0.5, 0.5, 0.0], [0.0, 0.0, 0.0]], jnp.float32
    )  # row 2 = padding
    uh = jnp.asarray([0, 2], jnp.int32)
    mix = jnp.asarray([[2.0, 99.0]], jnp.float32)  # 99 hits only the zero row
    out = np.asarray(heavy_scores(dense, uh, mix))
    assert out.tolist() == [[2.0, 0.0, 4.0]]


def test_sort2_two_level_matches_one_level(monkeypatch):
    """The 2-level quantized selection (_topk_quantized_reduce) must equal
    the one-level flat sort lane-for-lane: same docs, same dequantized
    vals, including near-uniform tie pileups, zero-score lanes inside
    runs, empty queries, and runs that start mid-row."""
    import numpy as np

    from nextsearch.ops.bm25_sparse import per_query_topk_flat

    rng = np.random.default_rng(3)
    Q, k2 = 64, 32
    n = 64 * 1024  # >= the 32768 threshold, divisible by 128
    # run lengths: heavy-tailed incl. zeros, mid-row starts guaranteed
    lens = rng.integers(0, 1500, Q)
    short = rng.random(Q) < 0.3  # mix in tiny/empty runs
    lens[short] = rng.integers(0, 40, int(short.sum()))
    total = int(lens.sum())
    assert total < n
    sq = np.full(n, Q, np.int32)
    sq[:total] = np.repeat(np.arange(Q, dtype=np.int32), lens)
    score = np.zeros(n, np.float32)
    # near-uniform scores: huge tie mass after quantization
    score[:total] = (1.0 + rng.integers(0, 3, total) * 1e-7).astype(np.float32)
    # sprinkle zero-score lanes INSIDE runs (duplicate-doc non-last lanes)
    zero_at = rng.random(total) < 0.1
    score[:total][zero_at] = 0.0
    payload = np.arange(n, dtype=np.int32) % 100003

    def run():
        d, v = per_query_topk_flat(
            jnp.asarray(sq), jnp.asarray(score), jnp.asarray(payload),
            Q, k2, jnp.int32(2**30), quantized=True,
        )
        return np.asarray(d), np.asarray(v)

    monkeypatch.setenv("NEXTSEARCH_SORT2_2LEVEL", "0")
    d1, v1 = run()
    monkeypatch.setenv("NEXTSEARCH_SORT2_2LEVEL", "1")
    d2, v2 = run()
    assert np.array_equal(d1, d2)
    assert np.array_equal(v1, v2)
    # sanity: pools actually filled for long runs
    assert (d1[lens >= k2][:, :k2] < 2**30).all()
