"""Heavy-term scoring: matmul + per-sub-tile max + hit counts.

The hybrid posting representation stores high-df ("heavy") terms as dense
per-doc score rows so their query-time contribution is one matrix product
(replacing the reference's per-posting disk loop for exactly the terms where
it is most expensive — src/api_engine.cpp:469-481):

    H[q, d]      = sum_r mix[q, r] * dense[r, d]      (f32 accumulate)
    smax[s, q]   = max_d-in-subtile H[q, d]           (CSUB-doc sub-tiles)
    counts[t, q] = #{d in tile : H[q, d] > 0}         (TILE-doc tiles)

Maxima are recorded per CSUB=128-doc sub-tile: candidate extraction then
gathers only the top sub-tiles' H values for a provable top-k2 bound (a
doc's own sub-tile max >= its score).

Precision is named explicitly (heavy_dot_algorithm), never left to a global
default: the exact mode is full f32, the guarded fast mode is TF32 on the
GPU over operands rounded to TF32 beforehand (tf32_round), so its error
bound does not depend on how the hardware converts f32 operands.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

TILE = 2048  # docs per count tile (doc_pad keeps n_slots a multiple)
CSUB = 128  # docs per candidate sub-tile (selection maxima granularity)
_CPT = TILE // CSUB  # candidate sub-tiles per count tile


def _round_up_store(h32, dtype):
    """Cast a NON-NEGATIVE f32 array for storage; bf16 rounds toward +inf.

    Round-up makes every stored selection value an UPPER bound on the f32
    accumulator, so the guarded fast path's exclusion proof ("every doc
    left out of the pool has approx <= tau, hence true <= (1+eps)*tau")
    needs NO epsilon for the storage rounding at all.
    For positive f32, adding 0xFFFF before truncating the mantissa to 8
    bits implements round-up exactly (mantissa carry rolls into the
    exponent, which is correct); zero stays zero, so positivity — and
    with it `found` — is preserved bit-exactly.
    """
    if dtype == jnp.float32:
        return h32
    bits = lax.bitcast_convert_type(h32, jnp.uint32)
    up = ((bits + jnp.uint32(0xFFFF)) >> jnp.uint32(16)).astype(jnp.uint16)
    return lax.bitcast_convert_type(up, jnp.bfloat16)


def tf32_round(x):
    """Round f32 to the nearest TF32 value (10 mantissa bits, ties to even).

    A TF32 product of already-TF32 operands is exact, so the fast mode's
    per-product error is the operands' rounding alone (<= 2^-11 each,
    relative) whether the tensor cores round or truncate what they are fed.
    Sign, zero and positivity are preserved; finite inputs stay finite.
    """
    bits = lax.bitcast_convert_type(x, jnp.uint32)
    lsb = (bits >> jnp.uint32(13)) & jnp.uint32(1)
    bits = (bits + jnp.uint32(0xFFF) + lsb) & jnp.uint32(0xFFFFE000)
    return lax.bitcast_convert_type(bits, jnp.float32)


def heavy_dot_algorithm(fast: bool):
    """Dot algorithm of the heavy product.

    Exact mode: F32_F32_F32 (full f32 operands, f32 accumulation) — H feeds
    UNGUARDED candidate selection, where near-uniform heavy terms (per-doc
    scores within ~1e-4) would otherwise collapse and the K2 pool could
    exclude true top-K docs.

    Fast mode (ONLY legal under the guarded pipeline, whose post-rescore
    threshold check relaunches the exact mode whenever the margin could
    matter): TF32_TF32_F32 on the GPU's tensor cores. XLA:CPU has no TF32
    algorithm, so on the CPU the fast mode runs the exact one, whose error
    is trivially inside the guard bound.
    """
    if fast and jax.default_backend() == "gpu":
        return lax.DotAlgorithmPreset.TF32_TF32_F32
    return lax.DotAlgorithmPreset.F32_F32_F32


def heavy_matmul(mix: jax.Array, dense: jax.Array, *, fast: bool = False):
    """H = mix @ dense in f32 at the heavy step's named precision.

    Fast mode pre-rounds both operands to TF32 (XLA fuses the rounding
    into the operand producers — for the compact table, into the row
    gather)."""
    if fast:
        mix, dense = tf32_round(mix), tf32_round(dense)
    return jnp.dot(
        mix.astype(dense.dtype),
        dense,
        preferred_element_type=jnp.float32,
        precision=heavy_dot_algorithm(fast),
    )


def heavy_fused_xla(
    mix: jax.Array, dense: jax.Array, *, fast: bool = False,
    h_dtype=jnp.float32,
):
    """Heavy step over a 2D table [ND, n_slots].

    Returns (H [Q, n_slots] in h_dtype, smax f32 [n_sub_pad, Q],
    counts f32 [n_tiles_pad, Q]); n_slots must be a multiple of TILE.
    h_dtype=bf16 is the guarded bf16 H storage (smax/counts still come
    from the f32 values). Positivity is exact at either precision (all
    operands positive, no cancellation), so counts never depend on it.
    """
    h32 = heavy_matmul(mix, dense, fast=fast)
    smax, cnt = tile_stats_xla(h32)
    return _round_up_store(h32, h_dtype), smax, cnt


def tile_stats_xla(totals: jax.Array):
    """Per-sub-tile maxima + per-tile positive counts of a totals matrix,
    padded to a multiple of 8 tiles (smax with -inf, counts with 0)."""
    Q, n_slots = totals.shape
    n_tiles = n_slots // TILE
    n_sub = n_slots // CSUB
    tiles_pad = ((n_tiles + 7) // 8) * 8
    sub_pad = tiles_pad * _CPT
    smax = jnp.transpose(jnp.max(totals.reshape(Q, n_sub, CSUB), axis=2))
    cnt = jnp.transpose(
        jnp.sum(
            (totals.reshape(Q, n_tiles, TILE) > 0), axis=2
        ).astype(jnp.float32)
    )
    neg = jnp.float32(-jnp.inf)
    return (
        jnp.pad(smax, ((0, sub_pad - n_sub), (0, 0)), constant_values=neg),
        jnp.pad(cnt, ((0, tiles_pad - n_tiles), (0, 0))),
    )


def heavy_fused3_xla(mix, dense3, *, fast: bool = False,
                     h_dtype=jnp.float32):
    """heavy_fused_xla over the STORED 3D table [ND, n_slots/128, 128];
    H comes back as [Q, n_slots/128, 128]. Both reshapes are free on a
    row-major layout."""
    dense2 = dense3.reshape(dense3.shape[0], -1)
    h, smax, cnt = heavy_fused_xla(mix, dense2, fast=fast, h_dtype=h_dtype)
    nblk = dense2.shape[1] // 128
    return h.reshape(h.shape[0], nblk, 128), smax, cnt


ENT_W = 128  # light entries per packed window
ENT_G = 4  # windows of trailing sentinel padding per group


def unified_fused_xla(mix, dense, ent_pack, eoff, *, fast: bool = False):
    """Heavy matmul + light-entry scatter-add + selection epilogue.

    ent_pack is int32 [NW, 8, ENT_W] packed entry windows (row 0 = doc
    slot, sorted asc, sentinel n_slots; row 1 = query row; row 2 =
    contribution f32 bit pattern; rows 3-7 unused); eoff[-1] is the live
    entry count. Returns (totals f32 [Q, n_slots], smax, counts) like
    heavy_fused_xla. On the GPU the scatter-add of colliding (q, doc)
    entries runs with atomics, so totals' f32 rounding order can vary
    between runs; selection is guarded or rescored exactly downstream.
    """
    Q = mix.shape[0]
    n_slots = dense.shape[1]
    H = heavy_matmul(mix, dense, fast=fast)
    docs_all = ent_pack[:, 0, :].reshape(-1)
    qs_all = ent_pack[:, 1, :].reshape(-1)
    vs_all = lax.bitcast_convert_type(
        ent_pack[:, 2, :], jnp.float32
    ).reshape(-1)
    n = eoff[-1]
    iota = lax.broadcasted_iota(jnp.int32, docs_all.shape, 0)
    live = iota < n
    docs = jnp.where(live, jnp.clip(docs_all, 0, n_slots - 1), 0)
    qs = jnp.where(live, jnp.clip(qs_all, 0, Q - 1), 0)
    vs = jnp.where(live, vs_all, 0.0)
    totals = H.at[qs, docs].add(vs)
    smax, cnt = tile_stats_xla(totals)
    return totals, smax, cnt
