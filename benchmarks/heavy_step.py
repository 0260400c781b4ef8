"""Heavy step on the card, at serving widths.

Measures, at Q=512 queries, uc=384 gathered dense rows and the 1M-doc
corpus's n_slots=1,001,472:

  kernel  time of heavy_fused3_xla in the exact f32 and the TF32 fast mode,
          each H's max relative error against a float64 host product, and
          whether counts/smax are exact;
  trace   per-op device time of each mode from a profiler trace (GEMM vs
          the rounding and reduction fusions);
  gather  the compact row gather dense_rows[ids] (time, GB/s, bit check).

Usage: python benchmarks/heavy_step.py [--out .bench_cache/out]
Prints one JSON line per measurement; fails without a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from nextsearch.utils.compilecache import enable_compilation_cache  # noqa: E402
from nextsearch.utils.device import card_line, require_gpu  # noqa: E402

Q, UC, N_SLOTS = 512, 384, 1_001_472


def emit(rec):
    print(json.dumps(rec), flush=True)


def timed(fn, *args, reps=20):
    import jax

    jax.block_until_ready(fn(*args))
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def make_operands(seed=0, weights="ones"):
    """mix [Q, UC] with 1-4 nonzero weights per query; dense [UC, N] with a
    per-row density from 0.1% to 60% (heavy rows of a Zipf corpus)."""
    import jax
    import jax.numpy as jnp

    r = np.random.default_rng(seed)
    mix = np.zeros((Q, UC), np.float32)
    for q in range(Q):
        cols = r.choice(UC, size=int(r.integers(1, 5)), replace=False)
        mix[q, cols] = 1.0 if weights == "ones" else r.uniform(0.05, 2.0,
                                                               len(cols))
    dens = np.exp(r.uniform(np.log(1e-3), np.log(0.6), UC)).astype(np.float32)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    u = jax.random.uniform(k1, (UC, N_SLOTS), jnp.float32)
    v = jax.random.uniform(k2, (UC, N_SLOTS), jnp.float32, 0.05, 9.0)
    dense = jnp.where(u < jnp.asarray(dens)[:, None], v, 0.0)
    return jnp.asarray(mix), dense.reshape(UC, N_SLOTS // 128, 128)


def h_errors(mix, dense_host, out):
    """Max relative error of H against the float64 product, counts check,
    smax == max of H check."""
    import jax

    H = np.asarray(jax.device_get(out[0])).reshape(Q, N_SLOTS)
    smax = np.asarray(jax.device_get(out[1]))
    cnt = np.asarray(jax.device_get(out[2]))
    mix = np.asarray(mix)
    worst = 0.0
    counts_ok = True
    n_tiles = N_SLOTS // 2048
    for q in range(Q):
        nz = np.flatnonzero(mix[q])
        ref = mix[q, nz].astype(np.float64) @ dense_host[nz].astype(np.float64)
        pos = ref > 0
        if np.any(H[q][~pos] != 0):
            counts_ok = False
        if pos.any():
            rel = np.abs(H[q][pos] - ref[pos]) / ref[pos]
            worst = max(worst, float(rel.max()))
        ref_cnt = pos.reshape(n_tiles, 2048).sum(axis=1)
        if not np.array_equal(cnt[:n_tiles, q], ref_cnt.astype(np.float32)):
            counts_ok = False
    smax_ok = bool(np.array_equal(
        smax[: N_SLOTS // 128], H.reshape(Q, -1, 128).max(axis=2).T
    ))
    return worst, counts_ok, smax_ok


def phase_kernel(out_dir):
    import jax
    import jax.numpy as jnp

    from nextsearch.ops.heavy import heavy_fused3_xla
    from nextsearch.utils.profiling import device_op_times

    mix, dense3 = make_operands()
    dense_host = np.asarray(jax.device_get(dense3)).reshape(UC, N_SLOTS)
    variants = {
        "xla_exact": jax.jit(lambda m, d: heavy_fused3_xla(m, d, fast=False)),
        "xla_tf32": jax.jit(lambda m, d: heavy_fused3_xla(m, d, fast=True)),
    }
    flops = 2.0 * Q * UC * N_SLOTS
    for name, fn in variants.items():
        ms = timed(fn, mix, dense3)
        worst, counts_ok, smax_ok = h_errors(mix, dense_host, fn(mix, dense3))
        emit({"phase": "kernel", "variant": name, "ms": ms,
              "tflops": flops / ms / 1e9, "h_max_rel_err": worst,
              "counts_exact": counts_ok, "smax_is_max_h": smax_ok})
    # non-unit weights: the mix operand's own TF32 rounding counts too
    mixw, _ = make_operands(seed=1, weights="random")
    worst, _, _ = h_errors(mixw, dense_host, variants["xla_tf32"](mixw, dense3))
    emit({"phase": "kernel", "variant": "xla_tf32_random_weights",
          "h_max_rel_err": worst})

    # profiler trace: per-op device time of each mode
    for name in variants:
        tdir = os.path.join(out_dir, f"trace_{name}")
        fn = variants[name]
        jax.block_until_ready(fn(mix, dense3))
        with jax.profiler.trace(tdir):
            for _ in range(5):
                jax.block_until_ready(fn(mix, dense3))
        ops = device_op_times(tdir)
        if not ops:  # show what the trace holds instead
            ops = {(k[0], "ALL " + k[1]): v
                   for k, v in device_op_times(tdir, "").items()}
        top = sorted(ops.items(), key=lambda kv: -kv[1][0])[:12]
        emit({"phase": "trace", "variant": name, "ops": [
            {"line": k[0], "op": k[1][:120], "ms_per_call":
             v[0] / 5 / 1e6, "count": v[1]} for k, v in top]})

    # compact row gather at the same widths: 512-row table, 384 ids
    table = jnp.concatenate([dense3, dense3[:128]], axis=0)  # [512, ...]
    ids = jnp.asarray(
        np.random.default_rng(2).choice(table.shape[0], size=UC,
                                        replace=False)
        .astype(np.int32)
    )
    gather = jax.jit(lambda t, i: t[i])
    ms = timed(gather, table, ids)
    got = np.asarray(jax.device_get(gather(table, ids)))
    host = np.asarray(jax.device_get(table))[np.asarray(ids)]
    nbytes = 2.0 * UC * N_SLOTS * 4
    emit({"phase": "gather", "ms": ms, "gb_per_s": nbytes / ms / 1e6,
          "bit_exact": bool(np.array_equal(got.view(np.uint32),
                                           host.view(np.uint32)))})


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(REPO / ".bench_cache" / "out"))
    args = ap.parse_args()
    enable_compilation_cache()
    dev = require_gpu()
    emit({"device": dev, "card": card_line()})
    Path(args.out).mkdir(parents=True, exist_ok=True)
    phase_kernel(args.out)


if __name__ == "__main__":
    main()
