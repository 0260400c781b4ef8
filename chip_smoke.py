"""Smoke test of the served BM25 path on the GPU, checked against the oracle.

One card (default):
  corpus   bench.py's seeded synthetic corpus at full size (1M docs,
           200k-term Zipf vocabulary, ~47M postings), saved as a segment
           artifact under .bench_cache/ (nothing is downloaded)
  server   `python -m nextsearch.api.server <dir> <port> --mode sparse` as a
           child process at bench.py's serving point (posting block 64,
           dense ratio 1/1024, 7 GiB of dense rows, heavy bucket 512, batch
           512, pipeline depth 2), warmed for the batch sizes used here
  requests /api/health, single GET /api/search, one POST /api/search_batch
           of 512 Zipf queries, GET /api/suggest
  parity   every served query against index/oracle.py: f32 scores
           bit-exact, same doc ids, same `found`; guard trips from the log
  kernels  after the server exits, in this process: the heavy step in both
           precision modes against a float64 product, the row gather, and
           the library-default fused mode twice against the oracle

--four-cards: only the sharded path — EVAL config 3's shape (4 x 250k-doc
segments) served with `--mesh 1,4`, checked against the oracle as above.

Only one JAX process holds a card at a time: this process starts no JAX
backend while the server child is alive. Refuses to run (non-zero exit, no
result line) where JAX finds no GPU. Last line on success:
  {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}

Usage: python chip_smoke.py [--four-cards] [--seed 0]
"""

from __future__ import annotations

import argparse
import http.client
import json
import os
import re
import signal
import socket
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path
from urllib.parse import quote

import numpy as np

REPO = Path(__file__).resolve().parent
CACHE = REPO / ".bench_cache"
OUT = CACHE / "logs"
BATCH = 512
BUDGET_S = 1150  # whole run, compilation included

SERVER_ENV = {
    "NEXTSEARCH_MAX_BATCH": str(BATCH),
    "NEXTSEARCH_PIPELINE_DEPTH": "2",
    "NEXTSEARCH_POSTING_BLOCK": "64",
    "NEXTSEARCH_DENSE_RATIO": str(1 / 1024),
    "NEXTSEARCH_DENSE_BYTES": str(7 << 30),
    "NEXTSEARCH_HEAVY_BUCKETS": "512",
    "NEXTSEARCH_WARMUP_SIZES": f"1,{BATCH}",
}
_T0 = time.time()


class SmokeFailure(Exception):
    pass


def say(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


@contextmanager
def phase(name: str):
    t0 = time.time()
    say(f"phase {name} ...")
    try:
        yield
    except SmokeFailure:
        say(f"phase {name} FAILED after {time.time() - t0:.1f} s")
        raise
    except Exception as e:
        say(f"phase {name} FAILED after {time.time() - t0:.1f} s: "
            f"{type(e).__name__}: {e}")
        raise SmokeFailure(name) from e
    say(f"phase {name}: {time.time() - t0:.1f} s")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------- parity


def served_hits(res: dict):
    """(found, [(score f32, segment, docId)]) from one /api/search result."""
    hits = [
        (np.float32(h["score"]), h["segment"], int(h["docId"]))
        for h in res["results"]
    ]
    return int(res["found"]), hits


def compare_result(res: dict, oracle, seg_names) -> str | None:
    """None when a served result equals the oracle's (hits, found) exactly:
    same found, same docs in the same order, f32 scores bit-equal."""
    hits, found = oracle
    s_found, s_hits = served_hits(res)
    if s_found != found:
        return f"found {s_found} != {found}"
    if len(s_hits) != len(hits):
        return f"{len(s_hits)} hits != {len(hits)}"
    for rank, ((s_sc, s_seg, s_doc), (o_sc, o_seg, o_doc)) in enumerate(
        zip(s_hits, hits)
    ):
        if (s_seg, s_doc) != (seg_names[o_seg], o_doc):
            return f"rank {rank}: doc {s_seg}/{s_doc} != " \
                   f"{seg_names[o_seg]}/{o_doc}"
        if np.float32(s_sc).view(np.uint32) != np.float32(o_sc).view(
            np.uint32
        ):
            return f"rank {rank}: score {s_sc!r} != {np.float32(o_sc)!r}"
    return None


def query_class(terms, heavy) -> str:
    kinds = {("heavy" if t in heavy else "light") for t, _w in terms}
    if len(terms) == 1:
        return f"1-term {kinds.pop()}"
    return "multi heavy+light" if len(kinds) == 2 else f"multi {kinds.pop()}"


def heavy_terms(segs, ratio: float, max_bytes: int):
    """Terms that get a dense row (DeviceIndex's rule, global df)."""
    n_docs = sum(s.N for s in segs)
    n_slots = -(-n_docs // 2048) * 2048
    thr = max(1, int(n_slots * ratio))
    cap = min(4096, max_bytes // (4 * n_slots))
    gdf: dict = {}
    for s in segs:
        for t, d in zip(s.terms, s.term_df.tolist()):
            gdf[t] = gdf.get(t, 0) + d
    top = sorted(((d, t) for t, d in gdf.items() if d >= thr), reverse=True)
    return {t for _d, t in top[:cap]}


# ---------------------------------------------------------------- server


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http_get(port: int, path: str, timeout: float = 600):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        c.request("GET", path)
        r = c.getresponse()
        return r.status, r.read()
    finally:
        c.close()


def http_post(port: int, path: str, body: bytes, timeout: float = 600):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        c.request("POST", path, body=body,
                  headers={"Content-Type": "application/json"})
        r = c.getresponse()
        return r.status, r.read()
    finally:
        c.close()


def write_index(segs, name: str) -> tuple[Path, list]:
    """Artifact-only segment directories + manifest the server loads."""
    from nextsearch.index.artifacts import save_artifact
    from nextsearch.index.segmentio import save_manifest

    root = CACHE / name
    seg_names = [f"seg_{i + 1:06d}" for i in range(len(segs))]
    for seg, sn in zip(segs, seg_names):
        save_artifact(seg, root / "segments" / sn)
    save_manifest(root / "manifest.bin", seg_names)
    return root, seg_names


def start_server(index_dir: Path, port: int, log_path: Path, mesh=None):
    env = dict(os.environ)
    env.update(SERVER_ENV)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    run_dir = CACHE / f"run_{port}"  # stats/cache JSONs land in the cwd
    run_dir.mkdir(parents=True, exist_ok=True)
    cmd = [sys.executable, "-u", "-m", "nextsearch.api.server",
           str(index_dir), str(port), "--mode", "sparse"]
    if mesh:
        cmd += ["--mesh", mesh]
    logf = open(log_path, "wb")
    proc = subprocess.Popen(cmd, cwd=str(run_dir), env=env, stdout=logf,
                            stderr=subprocess.STDOUT, start_new_session=True)
    return proc, logf


def wait_healthy(proc, port: int, deadline: float) -> dict:
    while time.time() < deadline:
        if proc.poll() is not None:
            raise SmokeFailure(f"server exited with {proc.returncode}")
        try:
            status, body = http_get(port, "/api/health", timeout=5)
            if status == 200:
                return json.loads(body)
        except OSError:
            pass
        time.sleep(1.0)
    raise SmokeFailure("server not healthy before the time budget")


def stop_server(proc, logf) -> None:
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGINT)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(timeout=30)
    logf.close()


def guard_trips(log_text: str) -> dict:
    """Fast-path guard trips the server logged, by how they were served."""
    out = {"queries": 0, "batches": 0, "host_rescue": 0, "relaunch": 0}
    for m in re.finditer(
        r"fast-heavy guard tripped \((\d+)/(\d+) queries\); "
        r"(host-oracle rescue|relaunching)", log_text
    ):
        out["queries"] += int(m.group(1))
        out["batches"] += 1
        key = "host_rescue" if m.group(3).startswith("host") else "relaunch"
        out[key] += int(m.group(1))
    return out


def serve_and_check(segs, seg_names, index_dir, probs, heavy, seed: int,
                    mesh=None) -> dict:
    """Start the server, send the requests, compare every served query
    with the oracle. Returns counters for the report."""
    import bench
    from nextsearch.index.oracle import oracle_search, oracle_search_vec

    port = free_port()
    OUT.mkdir(parents=True, exist_ok=True)
    log_path = OUT / ("smoke_server_mesh.log" if mesh else "smoke_server.log")
    batch = bench.sample_queries(probs, BATCH, BATCH, seed=seed + 1)[0]
    pool = bench.sample_queries(probs, 4 * BATCH, BATCH, seed=seed + 2)
    pool = [q for b in pool for q in b]
    singles = []
    for want, n in (("1-term heavy", 2), ("1-term light", 2),
                    ("multi heavy+light", 4)):
        singles += [q for q in pool if query_class(q, heavy) == want][:n]
    proc, logf = start_server(index_dir, port, log_path, mesh)
    try:
        with phase("oracle (while the server warms up)"):
            osegs = [s.to_oracle_segment() for s in segs]
            checked = singles + batch
            expect = [oracle_search_vec(osegs, q, k=10) for q in checked]
            # the vectorized oracle against the scalar one on a sample
            for q, e in list(zip(checked, expect))[:: len(checked) // 8]:
                check(oracle_search(osegs, q, k=10) == e,
                      f"oracle_search != oracle_search_vec for {q}")
        with phase("server start"):
            health = wait_healthy(proc, port, _T0 + BUDGET_S - 240)
            check(health.get("ok") is True, f"health {health}")
            check(health.get("segments") == len(segs), f"health {health}")
        served = []
        with phase("requests"):
            for q in singles:
                text = " ".join(t for t, _w in q)
                t0 = time.time()
                status, body = http_get(port,
                                        f"/api/search?q={quote(text)}&k=10")
                check(status == 200, f"GET /api/search {status} {body[:200]}")
                say(f"GET /api/search {query_class(q, heavy)} "
                    f"{(time.time() - t0) * 1e3:.1f} ms")
                served.append(json.loads(body))
            payload = json.dumps({"queries": [
                {"q": " ".join(t for t, _w in q), "k": 10} for q in batch
            ]}).encode()
            t0 = time.time()
            status, body = http_post(port, "/api/search_batch", payload)
            check(status == 200, f"POST /api/search_batch {status}")
            say(f"POST /api/search_batch n={BATCH} "
                f"{(time.time() - t0) * 1e3:.1f} ms")
            results = json.loads(body)["results"]
            check(len(results) == BATCH, f"{len(results)} batch results")
            served += results
            for prefix in ("t0", "t000", "t00001"):
                status, body = http_get(port, f"/api/suggest?q={prefix}&k=5")
                check(status == 200, f"suggest {status}")
                sugg = json.loads(body)["suggestions"]
                check(len(sugg) > 0, f"no suggestions for {prefix}")
        with phase("parity"):
            bad = []
            classes: dict = {}
            for q, res, e in zip(checked, served, expect):
                err = compare_result(res, e, seg_names)
                if err:
                    bad.append((q, err))
                c = query_class(q, heavy)
                classes[c] = classes.get(c, 0) + 1
            say(f"parity: {len(checked) - len(bad)}/{len(checked)} served "
                f"queries bit-exact against the oracle; classes {classes}")
            for q, err in bad[:10]:
                say(f"  MISMATCH {q}: {err}")
            check(not bad, f"{len(bad)} queries differ from the oracle")
            for c in ("1-term heavy", "1-term light", "multi heavy+light"):
                check(classes.get(c, 0) > 0, f"no {c} query checked")
    finally:
        stop_server(proc, logf)
    trips = guard_trips(log_path.read_text(errors="replace"))
    say(f"guard trips (server log, warmup included): {trips}")
    return {"checked": len(checked), "trips": trips}


# ---------------------------------------------------------------- kernels


def kernel_checks(seed: int, n_slots: int) -> None:
    """Each translated stage against its plain reference at real widths."""
    import jax

    sys.path.insert(0, str(REPO / "benchmarks"))
    import heavy_step as hs

    from nextsearch.config import DeviceConfig
    from nextsearch.ops.heavy import heavy_fused3_xla

    eps = DeviceConfig().fast_heavy_eps
    hs.N_SLOTS = n_slots
    mix, dense3 = hs.make_operands(seed)
    dense_host = np.asarray(jax.device_get(dense3)).reshape(hs.UC, n_slots)
    exact = jax.jit(lambda m, d: heavy_fused3_xla(m, d, fast=False))
    fast = jax.jit(lambda m, d: heavy_fused3_xla(m, d, fast=True))
    for name, fn, bound in (("exact", exact, 1e-6),
                            ("fast TF32", fast, eps / 3)):
        ms = hs.timed(fn, mix, dense3, reps=10)
        err, counts_ok, smax_ok = hs.h_errors(mix, dense_host, fn(mix, dense3))
        say(f"heavy step {name}: H max rel err {err:.3e} (bound {bound:.3e})"
            f", counts exact {counts_ok}, smax == max H {smax_ok}, "
            f"{ms:.3f} ms at Q={hs.Q} uc={hs.UC} n_slots={n_slots}")
        check(err <= bound and counts_ok and smax_ok, f"heavy {name}")
    mixw, _ = hs.make_operands(seed + 1, weights="random")
    err, _, _ = hs.h_errors(mixw, dense_host, fast(mixw, dense3))
    say(f"heavy step fast TF32, non-unit weights: H max rel err {err:.3e} "
        f"(guard eps {eps:.1e})")
    check(err <= eps, "fast mode error above the guard eps")

    table = dense3
    ids = jax.numpy.asarray(
        np.random.default_rng(seed).permutation(hs.UC).astype(np.int32)
    )
    got = np.asarray(jax.device_get(jax.jit(lambda t, i: t[i])(table, ids)))
    ok = np.array_equal(got.view(np.uint32),
                        dense_host.reshape(got.shape)[np.asarray(ids)]
                        .view(np.uint32))
    say(f"row gather dense_rows[ids]: bit-exact {ok}")
    check(ok, "row gather")
    del table, dense3, mix, mixw
    fused_mode_twice(seed)


def fused_mode_twice(seed: int) -> None:
    """Library-default fused mode (scatter-add with colliding indices) run
    twice over a 50k-doc corpus: both runs must equal the oracle."""
    import bench
    from nextsearch.config import DeviceConfig, EngineConfig
    from nextsearch.index.oracle import oracle_search_vec
    from nextsearch.index.segment import DeviceIndex

    seg, probs = bench.build_corpus(50_000, 50_000, seed=seed + 5)
    queries = bench.sample_queries(probs, 256, 256, seed=seed + 6)[0]
    di = DeviceIndex([seg], config=EngineConfig(device=DeviceConfig()))
    check(di.config.device.mode == "fused", "default mode is not fused")
    oseg = [seg.to_oracle_segment()]
    expect = [oracle_search_vec(oseg, q, k=10) for q in queries]
    for run in (1, 2):
        bad = 0
        for q, res, (hits, found) in zip(queries, di.search_batch(queries, 10),
                                         expect):
            same = res.found == found and len(res.scores) == len(hits) and all(
                di.locate(int(sl))[1] == od
                and np.float32(sc).view(np.uint32)
                == np.float32(osc).view(np.uint32)
                for (osc, _g, od), sc, sl in zip(hits, res.scores,
                                                 res.doc_slots)
            )
            bad += not same
        say(f"fused mode run {run}: {256 - bad}/256 queries bit-exact")
        check(bad == 0, f"fused mode run {run}")


# ---------------------------------------------------------------- main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="serve EVAL config 3 over --mesh 1,4 and nothing else")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    n_cards = 4 if args.four_cards else 1
    if not args.four_cards:
        os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    sys.path.insert(0, str(REPO))
    try:
        import bench
        from nextsearch.utils.compilecache import enable_compilation_cache
        from nextsearch.utils.device import card_line, probe_device
    except ImportError as e:
        say(f"refusing to run: the repository is not beside this script ({e})")
        return 2
    try:
        with phase("device"):
            dev = probe_device()
            say(f"JAX device: {dev}")
            if dev["platform"] != "gpu":
                raise SmokeFailure(
                    f"JAX finds no GPU (platform {dev['platform']!r}); "
                    "this smoke test runs only on the card"
                )
            check(dev["count"] >= n_cards,
                  f"{dev['count']} cards visible, {n_cards} needed")
            say(f"card: {card_line()}")
        CACHE.mkdir(exist_ok=True)
        with phase("corpus"):
            if args.four_cards:
                segs = [bench.build_corpus(250_000, 200_000, seed=10 + i)[0]
                        for i in range(4)]
                name = f"served_c3_{args.seed}"
            else:
                segs = [bench.build_corpus(1_000_000, 200_000,
                                           seed=args.seed)[0]]
                name = f"served_1m_{args.seed}"
            probs = 1.0 / np.arange(1, 200_001) ** 1.07
            probs /= probs.sum()
            index_dir, seg_names = write_index(segs, name)
            say(f"corpus: {sum(s.N for s in segs)} docs in {len(segs)} "
                f"segment(s), {sum(s.num_postings for s in segs)} postings")
            heavy = heavy_terms(segs, 1 / 1024, 7 << 30)
        report = serve_and_check(
            segs, seg_names, index_dir, probs, heavy, args.seed,
            mesh="1,4" if args.four_cards else None,
        )
        if not args.four_cards:
            n_slots = -(-segs[0].N // 2048) * 2048
            del segs
            with phase("kernels"):
                enable_compilation_cache()
                import jax

                used = jax.devices()
                check(used[0].platform == "gpu", "kernel phase not on a GPU")
                kernel_checks(args.seed, n_slots)
        say(f"served {report['checked']} queries oracle-exact; guard trips "
            f"{report['trips']['queries']}; {time.time() - _T0:.1f} s total")
    except SmokeFailure as e:
        say(f"FAILED: {e}")
        return 1
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"], "count": n_cards,
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
