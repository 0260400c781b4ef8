"""Served-QPS benchmark: drive the REAL HTTP server with concurrent load.

The product the reference ships is a server (src/api_server.cpp:373). This
harness serves the SAME 1M-doc corpus through `nextsearch.api.server`
(subprocess, real sockets, real JSON) and measures delivered QPS + p50 at
the client.

Two load shapes:
  --mode batch  (default): N client threads POST /api/search_batch with B
                queries per request (keep-alive). A device serving
                deployment is batch-oriented end to end; per-request HTTP
                costs host CPU time that a batch amortizes.
  --mode single: C asyncio connections issue GET /api/search each (the
                reference's request shape). Measures the per-request
                ceiling of the Python HTTP front on this host.

Usage: python benchmarks/load_http.py [--mode batch] [--docs 1000000]
         [--secs 20] [--clients 3] [--batch 512] [--port 18080]
         [--reuse-server]   # don't spawn; attach to a running server
Prints one JSON line per mode, naming the device and the card; fails
without a GPU. The load generator holds no card: the server (or, in engine
mode, this process) is the one JAX process on it.
"""

from __future__ import annotations

import argparse
import http.client
import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def make_query_texts(vocab: int, n_queries: int, seed: int = 3):
    """Zipf query stream as raw strings (same distribution as bench.py)."""
    probs = 1.0 / np.arange(1, vocab + 1) ** 1.07
    probs /= probs.sum()
    cum = np.cumsum(probs)
    cum[-1] = 1.0
    r = np.random.default_rng(seed)
    n_terms = r.integers(1, 5, size=n_queries)
    total = int(n_terms.sum())
    tids = np.searchsorted(cum, r.random(total), side="right")
    ends = np.cumsum(n_terms)
    out = []
    for qi in range(n_queries):
        s, e = ends[qi] - n_terms[qi], ends[qi]
        q = np.unique(tids[s:e])
        out.append(" ".join(f"t{t:06d}" for t in q))
    return out


def prepare_index_dir(docs: int, vocab: int) -> Path:
    """Serve the bench corpus: artifact-only segment dir (no binary files)."""
    cache = Path(
        os.environ.get("NEXTSEARCH_BENCH_CACHE", REPO / ".bench_cache")
    ) / f"{docs}_{vocab}_0"
    art = cache / "device_arrays.npz"
    if not art.exists():
        print(f"[load] building corpus artifact at {cache} (one-time)",
              file=sys.stderr)
        sys.path.insert(0, str(REPO))
        import bench

        seg, _probs = bench.build_corpus(docs, vocab)
        from nextsearch.index.artifacts import save_artifact

        save_artifact(seg, cache)
    served = REPO / ".bench_cache" / f"served_{docs}_{vocab}"
    segdir = served / "segments" / "seg_000001"
    segdir.mkdir(parents=True, exist_ok=True)
    link = segdir / "device_arrays.npz"
    if not link.exists():
        link.symlink_to(art)
    from nextsearch.index.segmentio import save_manifest

    save_manifest(served / "manifest.bin", ["seg_000001"])
    return served


def wait_healthy(port: int, timeout_s: float) -> None:
    deadline = time.time() + timeout_s
    last = None
    while time.time() < deadline:
        try:
            c = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
            c.request("GET", "/api/health")
            r = c.getresponse()
            body = r.read()
            c.close()
            if r.status == 200 and json.loads(body).get("ok"):
                return
        except OSError as e:
            last = e
        time.sleep(2.0)
    raise RuntimeError(f"server never became healthy: {last}")


def spot_check(port: int, queries):
    """Response-shape sanity on a small batch before the timed run."""
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    payload = json.dumps(
        {"queries": [{"q": q, "k": 10} for q in queries[:16]]}
    )
    c.request("POST", "/api/search_batch", body=payload,
              headers={"Content-Type": "application/json"})
    r = c.getresponse()
    j = json.loads(r.read())
    c.close()
    assert r.status == 200, r.status
    assert len(j["results"]) == 16
    n_nonempty = 0
    for res in j["results"]:
        scores = [hit["score"] for hit in res["results"]]
        assert scores == sorted(scores, reverse=True), res["query"]
        n_nonempty += bool(scores)
    assert n_nonempty >= 12, f"only {n_nonempty}/16 queries matched"
    print(f"[load] spot-check OK ({n_nonempty}/16 non-empty, sorted)",
          file=sys.stderr)


def run_batch_mode(port, texts, secs, clients, batch, k=10):
    """Threaded keep-alive POST /api/search_batch loop."""
    # Pre-encode payloads outside the timed loop; the client shares the one
    # core with the server, so client-side JSON work must be minimal.
    payloads = []
    for i in range(0, max(len(texts) - batch, 1), batch):
        payloads.append(
            json.dumps(
                {"queries": [{"q": q, "k": k} for q in texts[i : i + batch]]}
            ).encode()
        )
    lat, done, errors = [], [0], []
    stop = time.time() + secs
    lock = threading.Lock()

    def worker(wi):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        pi = wi
        while time.time() < stop:
            t0 = time.time()
            try:
                conn.request(
                    "POST", "/api/search_batch", body=payloads[pi % len(payloads)],
                    headers={"Content-Type": "application/json"},
                )
                r = conn.getresponse()
                body = r.read()
            except OSError as e:
                errors.append(e)
                conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
                continue
            dt = time.time() - t0
            if r.status != 200:
                errors.append(body[:200])
                continue
            with lock:
                lat.append(dt)
                done[0] += batch
            pi += clients
        conn.close()

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(clients)]
    t0 = time.time()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.time() - t0
    if errors:
        print(f"[load] {len(errors)} errors, first: {errors[0]}", file=sys.stderr)
    return done[0] / wall, float(np.median(lat)) * 1000 if lat else 0.0, len(errors)


def run_single_mode(port, texts, secs, conns, k=10):
    """asyncio GET /api/search load (per-request ceiling)."""
    import asyncio
    from urllib.parse import quote

    paths = [f"/api/search?q={quote(q)}&k={k}" for q in texts]
    lat = []
    done = [0]
    errors = [0]

    async def client(ci):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        pi = ci
        stop = time.time() + secs
        try:
            while time.time() < stop:
                p = paths[pi % len(paths)]
                t0 = time.time()
                writer.write(
                    f"GET {p} HTTP/1.1\r\nHost: x\r\n\r\n".encode()
                )
                await writer.drain()
                # status line, then headers
                status_line = await reader.readline()
                try:
                    status = int(status_line.split(b" ")[1])
                except (IndexError, ValueError):
                    status = 0
                clen = 0
                while True:
                    line = await reader.readline()
                    if not line or line == b"\r\n":
                        break
                    if line.lower().startswith(b"content-length:"):
                        clen = int(line.split(b":")[1])
                if clen:
                    await reader.readexactly(clen)
                if status == 200:
                    lat.append(time.time() - t0)
                    done[0] += 1
                else:  # non-200 must not inflate the published QPS
                    errors[0] += 1
                pi += conns
        except (OSError, asyncio.IncompleteReadError):
            errors[0] += 1
        finally:
            writer.close()

    async def main():
        await asyncio.gather(*(client(i) for i in range(conns)))

    t0 = time.time()
    asyncio.run(main())
    wall = time.time() - t0
    return done[0] / wall, float(np.median(lat)) * 1000 if lat else 0.0, errors[0]


def run_engine_mode(docs, vocab, texts, secs, batch):
    """In-process serving-dispatcher capacity: Engine + SearchBatcher at
    pipeline depth 2, no sockets. Upper-bounds what ANY HTTP front on this
    host could deliver; the gap to bench.py is the engine's host work
    (cache probes + tokenize + render + cache fill), the gap from HTTP
    modes is socket/JSON turnaround + the in-process load generator."""
    import threading as _t

    from nextsearch.api.batching import SearchBatcher
    from nextsearch.config import (
        BatchingConfig, CacheConfig, DeviceConfig, EngineConfig,
    )
    from nextsearch.engine import Engine
    from nextsearch.utils.compilecache import enable_compilation_cache

    enable_compilation_cache()
    index_dir = prepare_index_dir(docs, vocab)
    cfg = EngineConfig(
        device=DeviceConfig(
            mode="sparse", posting_block=64, heavy_buckets=(512,),
            dense_df_ratio=1 / 1024, dense_max_bytes=7 << 30,
        ),
        batching=BatchingConfig(max_batch=batch, pipeline_depth=2),
        # write-behind persistence like the server: the reference's
        # write-per-put default dumps the WHOLE growing cache JSON 512x
        # per batch (measured: +~30s per successive batch)
        cache=CacheConfig(flush_ms=1000),
    )
    import tempfile

    eng = Engine(index_dir, config=cfg, cache_dir=tempfile.mkdtemp())
    t0 = time.time()
    assert eng.reload()
    print(f"[load] engine reload {time.time() - t0:.1f}s", file=sys.stderr)
    # full Q-ladder warmup: engine cache hits shrink pending counts, so
    # EVERY Q bucket the plan can emit needs its compiled shape up front
    eng.warmup()
    b = SearchBatcher(eng, cfg.batching)
    reqs = [
        [(q, 10) for q in texts[i : i + batch]]
        for i in range(0, len(texts) - batch, batch)
    ]
    done, lat = [0], []
    stop = time.time() + secs
    lock = _t.Lock()

    def worker(wi):
        pi = wi
        while time.time() < stop:
            t0 = time.time()
            out = b.search_many(reqs[pi % len(reqs)])
            dt = time.time() - t0
            with lock:
                done[0] += len(out)
                lat.append(dt)
            pi += 3
    ts = [_t.Thread(target=worker, args=(i,)) for i in range(3)]
    t0 = time.time()
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    wall = time.time() - t0
    b.shutdown()
    return done[0] / wall, float(np.median(lat)) * 1000 if lat else 0.0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--mode", default="batch",
        choices=["batch", "single", "both", "engine"],
    )
    ap.add_argument("--docs", type=int, default=1_000_000)
    ap.add_argument("--vocab", type=int, default=200_000)
    ap.add_argument("--secs", type=float, default=20)
    ap.add_argument("--clients", type=int, default=3)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--conns", type=int, default=64)
    ap.add_argument("--port", type=int, default=18080)
    ap.add_argument("--reuse-server", action="store_true")
    ap.add_argument("--startup-timeout", type=float, default=5400)
    args = ap.parse_args()

    from nextsearch.utils.device import card_line, probe_device

    device = probe_device()
    if device["platform"] != "gpu":
        print(f"[load] no GPU: JAX runs on {device}", file=sys.stderr)
        return 1
    device["card"] = card_line()
    texts = make_query_texts(args.vocab, 40_000)
    if args.mode == "engine":
        qps, p50 = run_engine_mode(
            args.docs, args.vocab, texts, args.secs, args.batch
        )
        print(json.dumps({
            "metric": "served_qps_engine_dispatcher",
            "value": round(qps, 1), "unit": "queries/sec",
            "p50_req_ms": round(p50, 2), "batch": args.batch,
            "vs_baseline": round(qps / 10000.0, 4), "device": device,
        }))
        return 0
    proc = None
    if not args.reuse_server:
        index_dir = prepare_index_dir(args.docs, args.vocab)
        env = dict(os.environ)
        env.setdefault("NEXTSEARCH_MODE", "sparse")
        env.setdefault("NEXTSEARCH_MAX_BATCH", "512")
        env.setdefault("NEXTSEARCH_PIPELINE_DEPTH", "2")
        # serve the bench headline's exact device operating point so the
        # served number is comparable (bench.py sparse defaults)
        env.setdefault("NEXTSEARCH_POSTING_BLOCK", "64")
        env.setdefault("NEXTSEARCH_DENSE_RATIO", str(1 / 1024))
        env.setdefault("NEXTSEARCH_DENSE_BYTES", str(7 << 30))
        env.setdefault("NEXTSEARCH_HEAVY_BUCKETS", "512")
        # run from a scratch cwd: the server persists stats.json + cache
        # JSONs to its working directory (reference parity)
        run_dir = REPO / ".bench_cache" / f"run_{args.port}"
        run_dir.mkdir(parents=True, exist_ok=True)
        logf = open(run_dir / "server.log", "ab")
        env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
        proc = subprocess.Popen(
            [sys.executable, "-m", "nextsearch.api.server",
             str(index_dir), str(args.port)],
            cwd=str(run_dir), env=env, stdout=logf, stderr=logf,
        )
        print(f"[load] server pid {proc.pid}; waiting for health "
              f"(cold start: index upload + warmup compiles)", file=sys.stderr)
    try:
        wait_healthy(args.port, args.startup_timeout)
        spot_check(args.port, texts)
        out = []
        if args.mode in ("batch", "both"):
            qps, p50, errs = run_batch_mode(
                args.port, texts, args.secs, args.clients, args.batch
            )
            out.append({
                "metric": "served_qps_http_batch",
                "value": round(qps, 1), "unit": "queries/sec",
                "p50_req_ms": round(p50, 2), "clients": args.clients,
                "batch": args.batch, "errors": errs,
                "vs_baseline": round(qps / 10000.0, 4),
            })
        if args.mode in ("single", "both"):
            qps, p50, errs = run_single_mode(
                args.port, texts, args.secs, args.conns
            )
            out.append({
                "metric": "served_qps_http_single",
                "value": round(qps, 1), "unit": "queries/sec",
                "p50_req_ms": round(p50, 2), "conns": args.conns,
                "errors": errs,
                "vs_baseline": round(qps / 10000.0, 4),
            })
        for line in out:
            line["device"] = device
            print(json.dumps(line))
    finally:
        if proc is not None:
            proc.send_signal(signal.SIGINT)
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
    return 0


if __name__ == "__main__":
    sys.exit(main())
