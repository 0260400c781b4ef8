"""Heavy step (ops/heavy.py) against a float64 numpy reference.

On the CPU both precision modes run XLA's f32 algorithm (XLA:CPU has no
TF32); the fast mode still rounds its operands to TF32 first, so its error
is the rounding's, which the guard's eps must cover.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from nextsearch.config import DeviceConfig
from nextsearch.ops.heavy import (
    CSUB,
    TILE,
    heavy_fused3_xla,
    heavy_fused_xla,
    heavy_matmul,
    tf32_round,
)

Q, ND, N = 24, 40, 3 * TILE


def _operands(seed, unit_weights=True):
    r = np.random.default_rng(seed)
    mix = np.zeros((Q, ND), np.float32)
    for q in range(Q):
        cols = r.choice(ND, size=int(r.integers(1, 5)), replace=False)
        mix[q, cols] = 1.0 if unit_weights else r.uniform(0.05, 2.0, len(cols))
    mix[-1] = 0.0  # a query with no heavy term
    dense = np.where(
        r.random((ND, N)) < r.uniform(0.001, 0.5, (ND, 1)),
        r.uniform(0.05, 9.0, (ND, N)), 0.0,
    ).astype(np.float32)
    return mix, dense


def _reference(mix, dense):
    h = mix.astype(np.float64) @ dense.astype(np.float64)
    n_tiles, n_sub = N // TILE, N // CSUB
    smax = h.reshape(Q, n_sub, CSUB).max(axis=2).T
    cnt = (h > 0).reshape(Q, n_tiles, TILE).sum(axis=2).T
    return h, smax, cnt


@pytest.mark.parametrize("layout", ["2d", "3d"])
@pytest.mark.parametrize("fast", [False, True])
def test_heavy_step_matches_float64(layout, fast):
    mix, dense = _operands(3)
    h_ref, smax_ref, cnt_ref = _reference(mix, dense)
    if layout == "2d":
        H, smax, cnt = heavy_fused_xla(jnp.asarray(mix), jnp.asarray(dense),
                                       fast=fast)
    else:
        H, smax, cnt = heavy_fused3_xla(
            jnp.asarray(mix), jnp.asarray(dense).reshape(ND, N // 128, 128),
            fast=fast,
        )
        assert H.shape == (Q, N // 128, 128)
    H = np.asarray(H, np.float64).reshape(Q, N)
    pos = h_ref > 0
    assert np.array_equal(H > 0, pos)  # positivity exact in both modes
    rel = np.abs(H[pos] - h_ref[pos]) / h_ref[pos]
    bound = 2.0 ** -11 if fast else 1e-6  # unit weights: dense rounding only
    assert rel.max() <= bound, rel.max()
    n_sub, n_tiles = N // CSUB, N // TILE
    smax, cnt = np.asarray(smax), np.asarray(cnt)
    # padded to a multiple of 8 tiles: -inf maxima, zero counts
    assert smax.shape == (8 * TILE // CSUB, Q) and cnt.shape == (8, Q)
    assert np.all(np.isneginf(smax[n_sub:])) and not cnt[n_tiles:].any()
    assert np.array_equal(cnt[:n_tiles], cnt_ref)
    # smax is the max of the H the step returned, and near the exact max
    assert np.array_equal(smax[:n_sub], H.reshape(Q, n_sub, CSUB).max(2).T)
    np.testing.assert_allclose(smax[:n_sub], smax_ref, rtol=bound, atol=0)


def test_fast_mode_error_within_guard_eps_for_any_weights():
    """Arbitrary query weights round too: still inside fast_heavy_eps."""
    mix, dense = _operands(4, unit_weights=False)
    h_ref = mix.astype(np.float64) @ dense.astype(np.float64)
    H = np.asarray(heavy_matmul(jnp.asarray(mix), jnp.asarray(dense),
                                fast=True), np.float64)
    pos = h_ref > 0
    rel = np.abs(H[pos] - h_ref[pos]) / h_ref[pos]
    assert rel.max() <= 2 * 2.0 ** -11 * (1 + 2.0 ** -11)
    assert rel.max() <= DeviceConfig().fast_heavy_eps / 2


def test_tf32_round_is_nearest_ten_bit_mantissa():
    r = np.random.default_rng(5)
    x = np.concatenate([
        r.uniform(-1e3, 1e3, 20000), r.uniform(0, 1e-30, 100),
        [0.0, -0.0, 1.0, 3.0e38],
    ]).astype(np.float32)
    y = np.asarray(tf32_round(jnp.asarray(x)))
    bits = y.view(np.uint32)
    assert not np.any(bits & 0x1FFF)  # 10 mantissa bits left
    assert np.array_equal(np.sign(y), np.sign(x))
    nz = x != 0
    rel = np.abs(y[nz].astype(np.float64) - x[nz]) / np.abs(x[nz])
    assert rel.max() <= 2.0 ** -11
    # round to nearest: no other TF32 value is closer
    step = np.abs(y).view(np.uint32) + np.uint32(0x2000)
    up = step.view(np.float32).astype(np.float64)
    assert np.all(np.abs(np.abs(x[nz]) - np.abs(y[nz])) <= np.abs(
        up[nz] - np.abs(y[nz])) / 2 + 1e-45)
    # already-TF32 values are fixed points
    assert np.array_equal(np.asarray(tf32_round(jnp.asarray(y))), y)


@pytest.mark.gpu
def test_fast_mode_runs_tf32_on_the_card(gpu_device):
    """On the GPU the fast mode names TF32 and stays inside its bound."""
    from jax import lax

    from nextsearch.ops.heavy import heavy_dot_algorithm

    assert heavy_dot_algorithm(True) == lax.DotAlgorithmPreset.TF32_TF32_F32
    assert heavy_dot_algorithm(False) == lax.DotAlgorithmPreset.F32_F32_F32
    mix, dense = _operands(6)
    h_ref, _smax, cnt_ref = _reference(mix, dense)
    for fast, bound in ((False, 1e-6), (True, 2.0 ** -11)):
        H, _s, cnt = heavy_fused_xla(jnp.asarray(mix), jnp.asarray(dense),
                                     fast=fast)
        H = np.asarray(H, np.float64)
        pos = h_ref > 0
        assert np.array_equal(H > 0, pos)
        assert (np.abs(H[pos] - h_ref[pos]) / h_ref[pos]).max() <= bound
        assert np.array_equal(np.asarray(cnt)[: N // TILE], cnt_ref)
