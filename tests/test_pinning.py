"""Shape-pinning regression tests (VERDICT r2 items 2/3).

Recompile flapping — a batch-varying static kernel shape (T, Q, C, U)
crossing a bucket boundary mid-serving — is THE serving-throughput killer
(measured in round 2: an unpinned static U collapsed serving to 141 QPS).
pin_shapes() must make every batch inside the pinned envelope produce
IDENTICAL static shapes, so XLA compiles exactly one program.
"""

import numpy as np
import pytest

from nextsearch.config import DeviceConfig, EngineConfig
from nextsearch.index.builder import build_segment_arrays
from nextsearch.index.segment import DeviceIndex


def _mk_segments(n_docs=300, vocab=48, seed=7):
    r = np.random.default_rng(seed)
    words = [f"w{i:03d}" for i in range(vocab)]
    docs = []
    for i in range(n_docs):
        toks = r.integers(0, vocab, size=int(r.integers(5, 40)))
        docs.append({"cord_uid": f"d{i}", "tokens": [words[t] for t in toks]})
    return [build_segment_arrays(docs)]


def _queries(rng, vocab, n, tmin=1, tmax=5):
    qs = []
    for _ in range(n):
        k = int(rng.integers(tmin, tmax + 1))
        terms = rng.choice(vocab, size=min(k, vocab), replace=False)
        qs.append([(f"w{t:03d}", 1.0) for t in terms])
    return qs


@pytest.fixture(scope="module")
def sparse_index():
    cfg = EngineConfig(
        device=DeviceConfig(mode="sparse", dense_df_ratio=1 / 8)
    )
    return DeviceIndex(_mk_segments(), config=cfg)


def _sparse_static_shapes(di, batch):
    """The tuple of batch-varying static shapes that key the sparse
    kernel's compilation."""
    plan, U = di.plan_sparse(batch)
    C = di._chunk_budget(plan[1], di.config.device.posting_block)
    L2 = di._light_budget(plan)
    H2 = di._heavy_budget(plan)
    _seven, Qb, T = plan.shape
    return (Qb, T, C, U, L2, H2)


def test_pinned_sparse_shapes_are_batch_invariant(sparse_index):
    di = sparse_index
    rng = np.random.default_rng(0)
    probe = [_queries(rng, 48, n) for n in (8, 16)]
    pins = di.pin_shapes(probe)
    assert set(pins) == {"T", "Q", "C", "U", "W", "L", "HP"}

    shapes = set()
    for n in (1, 3, 8, 11, 16):
        shapes.add(_sparse_static_shapes(di, _queries(rng, 48, n)))
    assert len(shapes) == 1, (
        f"batches inside the pinned envelope compiled {len(shapes)} "
        f"distinct shapes: {shapes}"
    )
    di._pins.clear()


def test_unpinned_bucket_straddle_changes_shapes(sparse_index):
    """Sanity: without pins the same workload DOES straddle buckets —
    otherwise the invariance test above proves nothing."""
    di = sparse_index
    rng = np.random.default_rng(1)
    shapes = set()
    for n in (1, 3, 8, 11, 16):
        shapes.add(_sparse_static_shapes(di, _queries(rng, 48, n)))
    assert len(shapes) > 1


def test_pin_overflow_escape_is_bounded(sparse_index):
    """A batch exceeding a pin escapes to the next MULTIPLE of the pin
    (bounded distinct shapes), never to an arbitrary bucket."""
    di = sparse_index
    rng = np.random.default_rng(2)
    di.pin_shapes(T=2, Q=4, C=128, U=16)
    qs = _queries(rng, 48, 6, tmin=5, tmax=5)  # T=5 > pin 2, Q=6 > pin 4
    Qb, T, C, U, _L2, _H2 = _sparse_static_shapes(di, qs)
    assert T == 6 and T % 2 == 0  # 5 -> next multiple of 2
    assert Qb == 8 and Qb % 4 == 0
    di._pins.clear()


def test_fused_plan_honors_pins(sparse_index):
    cfg = EngineConfig(device=DeviceConfig(mode="fused", dense_df_ratio=1 / 8))
    di = DeviceIndex(_mk_segments(), config=cfg)
    rng = np.random.default_rng(3)
    probe = [_queries(rng, 48, n) for n in (4, 12)]
    di.pin_shapes(probe)
    shapes = set()
    for n in (2, 5, 9, 12):
        batch = _queries(rng, 48, n)
        starts, dfs, weights, light_dfs, unique_heavy, heavy_mix = (
            di.plan_full(batch)
        )
        C = di._chunk_budget(light_dfs, di.config.device.posting_block)
        shapes.add(
            (starts.shape, unique_heavy.shape[0] if unique_heavy.ndim else 0,
             heavy_mix.shape, C)
        )
    assert len(shapes) == 1, shapes


def test_scoped_pins_per_batch_size(sparse_index):
    """pin_shapes(scope_q=True) freezes C/U/W per Q envelope: batches in
    one Q bucket share ONE shape, while other Q buckets keep their own
    envelopes (a 1-query request must not pad to the max-batch C)."""
    di = sparse_index
    rng = np.random.default_rng(5)
    # tmax=4 keeps T inside its first ladder bucket: T is deliberately
    # NOT scoped (see pin_shapes), so the probe must not straddle it.
    small = di.pin_shapes(
        [_queries(rng, 48, 8, tmax=4) for _ in range(4)], scope_q=True
    )
    big = di.pin_shapes(
        [_queries(rng, 48, 16, tmax=4) for _ in range(4)], scope_q=True
    )
    (qb_small,) = small.keys()
    (qb_big,) = big.keys()
    assert qb_small < qb_big
    assert set(small[qb_small]) == {"C", "U", "W", "L", "HP"}

    shapes_small = {
        _sparse_static_shapes(di, _queries(rng, 48, n, tmax=4))
        for n in (2, 5, 8)
    }
    shapes_big = {
        _sparse_static_shapes(di, _queries(rng, 48, n, tmax=4))
        for n in (9, 13, 16)
    }
    assert len(shapes_small) == 1, shapes_small
    assert len(shapes_big) == 1, shapes_big
    # the small scope really is smaller work: its C envelope must not
    # inherit the big batch's chunk budget
    (qs, _ts, cs, _us, _ls, _hs) = next(iter(shapes_small))
    (qbig, _tb, cb, _ub, _lb, _hb) = next(iter(shapes_big))
    assert qs == qb_small and qbig == qb_big
    assert cs <= cb
    di._qpins.clear()


def test_scoped_pin_beats_global(sparse_index):
    di = sparse_index
    rng = np.random.default_rng(6)
    di.pin_shapes(C=4096, U=64)  # global
    di.pin_shapes([_queries(rng, 48, 4) for _ in range(4)], scope_q=True)
    qb = next(iter(di._qpins))
    scoped_c = di._qpins[qb]["C"]
    assert scoped_c < 4096
    _q, _t, C, _u, _l, _h = _sparse_static_shapes(di, _queries(rng, 48, 4))
    assert C == scoped_c  # scoped pin wins inside its envelope
    # outside the scoped envelope the global pin still applies
    _q2, _t2, C2, _u2, _l2, _h2 = _sparse_static_shapes(
        di, _queries(rng, 48, 16)
    )
    assert C2 == 4096
    di._pins.clear()
    di._qpins.clear()


def test_engine_warmup_pins_scopes(tmp_path, monkeypatch):
    from nextsearch.engine import Engine
    from nextsearch.index.segmentio import save_manifest, write_segment

    d = tmp_path / "index"
    (d / "segments").mkdir(parents=True)
    rng = np.random.default_rng(9)
    docs = [
        {
            "cord_uid": f"d{i}",
            "tokens": [f"w{t:03d}" for t in rng.integers(0, 48, size=12)],
        }
        for i in range(200)
    ]
    from nextsearch.index.builder import build_segment_arrays

    write_segment(build_segment_arrays(docs), d / "segments" / "seg_000001")
    save_manifest(d / "manifest.bin", ["seg_000001"])
    monkeypatch.chdir(tmp_path)
    eng = Engine(d, cache_dir=tmp_path)
    assert eng.reload()
    assert eng.warmup(k_values=(10,)) > 0
    # warmup pinned one scope per distinct warmup Q envelope
    from nextsearch.index.segment import _bucket as _b

    # r4: warmup covers the full Q-bucket ladder (any coalesced serving
    # batch size must hit a precompiled envelope), plus multiples of the
    # top bucket up to max_batch
    mb = eng.config.batching.max_batch
    buckets = list(eng.index.Q_BUCKETS)
    sizes = {q for q in buckets if q < mb}
    sizes |= set(range(buckets[-1] * 2, mb, buckets[-1]))
    sizes.add(mb)
    expected = {_b(s, eng.index.Q_BUCKETS) for s in sizes}
    assert set(eng.index._qpins) == expected
    for scope in eng.index._qpins.values():
        assert "C" in scope and "U" in scope


def test_sharded_pin_shapes():
    import jax

    from nextsearch.parallel.mesh import make_mesh
    from nextsearch.parallel.sharded import ShardedIndex

    segs = _mk_segments() + _mk_segments(seed=8)
    mesh = make_mesh(dp=2, seg=2, devices=jax.devices()[:4])
    cfg = EngineConfig(
        device=DeviceConfig(mode="sparse", dense_df_ratio=1 / 8)
    )
    si = ShardedIndex(segs, mesh, config=cfg)
    rng = np.random.default_rng(4)
    probe = [_queries(rng, 48, n) for n in (4, 12)]
    pins = si.pin_shapes(probe)
    assert pins["T"] >= 1 and pins["C"] >= 1

    shapes = set()
    for n in (2, 7, 12):
        pi, U = si.plan_sparse(_queries(rng, 48, n))
        T = pi.shape[2] // 7
        C = si._chunk_budget(
            pi[:, :, T : 2 * T], si.config.device.posting_block
        )
        shapes.add((pi.shape, C, U, si._light_budget(pi)))
    assert len(shapes) == 1, shapes
    si._pins.clear()


def test_pin_borrows_from_larger_envelope():
    """An unwarmed Q envelope must borrow the nearest larger warmed
    envelope's pins instead of re-deriving budgets per batch (unpinned
    statics flap -> a fresh XLA compile per serving batch; measured as
    served QPS 9.5 with 39s launch spans while device exec was 62 ms)."""
    segs = _mk_segments()
    cfg = EngineConfig(device=DeviceConfig(mode="sparse", dense_df_ratio=1 / 8))
    di = DeviceIndex(segs, config=cfg)
    di._qpins = {
        1: {"C": 128, "U": 16, "W": 512, "L": 128, "HP": 128},
        512: {"C": 3584, "U": 432, "W": 8192, "L": 512, "HP": 1024},
    }
    # exact scoped match wins
    assert di._pin("C", 512) == 3584
    assert di._pin("C", 1) == 128
    # unwarmed envelope between warmed ones borrows the next larger
    assert di._pin("C", 256) == 3584
    assert di._pin("W", 64) == 8192
    # beyond the largest warmed envelope there is nothing safe to borrow
    # (a smaller pin would under-budget and flap escapes) -> unpinned
    assert di._pin("C", 1024) is None
    # no scoped pins at all falls back to the global pin
    di._qpins = {}
    di._pins = {"C": 777}
    assert di._pin("C", 256) == 777


def test_pick_shape_off_ladder_rounds_to_top_bucket():
    """Unpinned sizes past the bucket ladder must round up to multiples of
    the largest bucket — raw sizes would give every serving batch its own
    compiled shape (engine cache hits shrink pending counts 512 -> 460 ->
    422 -> ..., measured as one fresh ~25s XLA compile PER BATCH)."""
    from nextsearch.index.segment import _pick_shape

    ladder = (1, 8, 16, 32, 64, 128)
    assert _pick_shape(460, ladder, None) == 512
    assert _pick_shape(422, ladder, None) == 512
    assert _pick_shape(129, ladder, None) == 256
    assert _pick_shape(512, ladder, None) == 512
    assert _pick_shape(513, ladder, None) == 640
    # on-ladder sizes still bucket normally
    assert _pick_shape(3, ladder, None) == 8
    assert _pick_shape(128, ladder, None) == 128
    # pins still dominate
    assert _pick_shape(460, ladder, 512) == 512
