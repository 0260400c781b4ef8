"""HTTP/JSON API server — the reference's route surface on stdlib http.server.

Routes (parity with src/api_server.cpp:91-365):
  OPTIONS .*            CORS preflight, 204
  GET  /api/health      {ok, segments}
  GET  /api/search      BM25 search with timing fields + LRU cache semantics
  GET  /api/suggest     autocomplete
  GET  /api/ai_overview Azure OpenAI overview of search results
  GET  /api/ai_summary  Azure OpenAI abstract summary by cord_uid
  GET  /api/stats       counters + hit rates + last-10 feedback
  POST /api/add_document  503-disabled by default (reference parity); set
                          NEXTSEARCH_ENABLE_ADD_DOCUMENT=1 for the real
                          upload -> build -> publish pipeline
  POST /api/reload      reload index from disk
  POST /api/feedback    validated feedback intake

Error semantics match the reference: missing q -> 400 {"error":"missing q
param"}; malformed int params -> 500 {"error":"internal server error"} (the
reference's std::stoi throws into the exception handler); unconfigured Azure
-> 503 with the reference's message.

Concurrent /api/search requests are coalesced into batched device launches
by api/batching.SearchBatcher instead of serializing behind a mutex.
"""

from __future__ import annotations

import json
import os
import re
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Optional
from urllib.parse import parse_qs, urlparse

from ..config import DEFAULT_CONFIG, EngineConfig
from ..engine import Engine
from ..utils.envloader import load_env_file
from ..utils.logging import log
from .ai import AzureOpenAIConfig, generate_ai_overview, generate_ai_summary
from .batching import SearchBatcher
from .feedback import FeedbackManager, validate_and_add
from .stats import StatsTracker

_STOI_RE = re.compile(r"^\s*[+-]?\d+")


def stoi(s: str) -> int:
    """std::stoi semantics: parse the leading integer, throw otherwise."""
    m = _STOI_RE.match(s)
    if not m:
        raise ValueError(f"stoi: no conversion: {s!r}")
    return int(m.group(0))


class ServerContext:
    """Shared state across handler threads."""

    def __init__(
        self,
        engine: Engine,
        stats: StatsTracker,
        feedback: FeedbackManager,
        azure: AzureOpenAIConfig,
        config: EngineConfig = DEFAULT_CONFIG,
        transport=None,
        enable_add_document: bool = False,
    ):
        self.engine = engine
        self.stats = stats
        self.feedback = feedback
        self.azure = azure
        self.config = config
        self.transport = transport
        self.enable_add_document = enable_add_document
        self.batcher = SearchBatcher(engine, config.batching)
        from .batching import SuggestBatcher

        self.suggest_batcher = SuggestBatcher(engine, config.batching)


class ApiHandler(BaseHTTPRequestHandler):
    ctx: ServerContext  # injected by make_server
    protocol_version = "HTTP/1.1"

    # ---------------- plumbing ----------------

    def log_message(self, fmt, *args):  # reference svr.set_logger
        pass  # handled in _respond

    def _cors(self):
        # parity with src/api_http.cpp enable_cors
        self.send_header("Access-Control-Allow-Origin", "*")
        self.send_header("Access-Control-Allow-Methods", "GET, POST, OPTIONS")
        self.send_header(
            "Access-Control-Allow-Headers",
            "Content-Type, Accept, Origin, X-Requested-With, Authorization",
        )
        self.send_header("Access-Control-Max-Age", "600")

    def _respond(self, status: int, payload, extra_headers=None,
                 compact=False, raw: Optional[bytes] = None):
        # Reference routes pretty-print (json.dump(2), src/api_server.cpp);
        # the batched route (ours) uses compact separators — indent=2 on a
        # multi-MB 512-result payload costs ~100+ ms of the 1-core host.
        # `raw` sends pre-serialized JSON bytes (native render path).
        if raw is not None:
            body = raw
        else:
            body = (
                (
                    json.dumps(payload, separators=(",", ":"))
                    if compact
                    else json.dumps(payload, indent=2)
                ).encode("utf-8")
                if payload is not None
                else b""
            )
        self.send_response(status)
        self._cors()
        if payload is not None or raw is not None:
            self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if extra_headers:
            for k, v in extra_headers.items():
                self.send_header(k, v)
        self.end_headers()
        if body:
            self.wfile.write(body)
        log("http", f"{self.command} {urlparse(self.path).path} -> {status}")

    def _params(self):
        q = parse_qs(urlparse(self.path).query, keep_blank_values=True)
        return {k: v[0] for k, v in q.items()}

    def _body(self) -> bytes:
        length = int(self.headers.get("Content-Length", 0) or 0)
        return self.rfile.read(length) if length else b""

    def _route(self):
        return urlparse(self.path).path

    # ---------------- methods ----------------

    def do_OPTIONS(self):
        # Request headers/method echoes REPLACE the defaults (the reference's
        # httplib set_header overwrites; src/api_server.cpp:92-103).
        headers = {
            "Access-Control-Allow-Origin": "*",
            "Access-Control-Allow-Methods": "GET, POST, OPTIONS",
            "Access-Control-Allow-Headers": (
                "Content-Type, Accept, Origin, X-Requested-With, Authorization"
            ),
            "Access-Control-Max-Age": "600",
        }
        acrh = self.headers.get("Access-Control-Request-Headers")
        if acrh:
            headers["Access-Control-Allow-Headers"] = acrh
        acrm = self.headers.get("Access-Control-Request-Method")
        if acrm:
            headers["Access-Control-Allow-Methods"] = acrm + ", OPTIONS"
        self.send_response(204)
        for k, v in headers.items():
            self.send_header(k, v)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def do_GET(self):
        try:
            path = self._route()
            if path == "/api/health":
                return self._handle_health()
            if path == "/api/search":
                return self._handle_search()
            if path == "/api/suggest":
                return self._handle_suggest()
            if path == "/api/ai_overview":
                return self._handle_ai_overview()
            if path == "/api/ai_summary":
                return self._handle_ai_summary()
            if path == "/api/stats":
                return self._handle_stats()
            return self._respond(404, {"error": "not found"})
        except BrokenPipeError:
            pass
        except Exception as e:
            log("exception", f"{self.command} {self.path} : {e}")
            self._respond(500, {"error": "internal server error"})

    def do_POST(self):
        try:
            path = self._route()
            if path == "/api/reload":
                return self._handle_reload()
            if path == "/api/feedback":
                return self._handle_feedback()
            if path == "/api/add_document":
                return self._handle_add_document()
            if path == "/api/search_batch":
                return self._handle_search_batch()
            return self._respond(404, {"error": "not found"})
        except BrokenPipeError:
            pass
        except Exception as e:
            log("exception", f"{self.command} {self.path} : {e}")
            self._respond(500, {"error": "internal server error"})

    # ---------------- handlers ----------------

    def _handle_health(self):
        self._respond(
            200, {"ok": True, "segments": len(self.ctx.engine.seg_names)}
        )

    def _handle_search(self):
        total_t0 = time.perf_counter()
        params = self._params()
        if "q" not in params:
            return self._respond(400, {"error": "missing q param"})
        q = params["q"]
        k = stoi(params["k"]) if "k" in params else 10
        hybrid = params.get("hybrid") == "1"  # ours: dense rerank opt-in

        search_t0 = time.perf_counter()
        if hybrid:
            j = self.ctx.engine.search_hybrid(q, k)
        else:
            j = self.ctx.batcher.search(q, k)
        if hasattr(j, "to_dict"):  # caches.Rendered (native render)
            j = j.to_dict()
        search_ms = (time.perf_counter() - search_t0) * 1000.0

        from_cache = bool(j.get("from_cache"))
        self.ctx.stats.increment_searches()
        if from_cache:
            self.ctx.stats.increment_search_cache_hits()
            j["search_time_ms"] = 0.0
            j["cache_lookup_ms"] = search_ms
            j["total_time_ms"] = (time.perf_counter() - total_t0) * 1000.0
            j["cached"] = True
            j.pop("from_cache", None)
            log("search", f'q="{q}" k={k} CACHED cache_lookup={search_ms:.3f}ms')
        else:
            j["search_time_ms"] = search_ms
            j["total_time_ms"] = (time.perf_counter() - total_t0) * 1000.0
            j["cached"] = False
            log("search", f'q="{q}" k={k} search={search_ms:.3f}ms')
        self._respond(200, j)

    def _handle_search_batch(self):
        """Ours (no reference counterpart): many queries per HTTP request.

        POST {"queries": [{"q": "...", "k": 10}, ...]} ->
        {"results": [<same shape as /api/search>...], "search_time_ms": N}.
        A device serving front is batch-oriented end to end: per-request
        HTTP costs host CPU time, so a production client (or an upstream
        gateway) amortizes it across a batch. The
        batch coalesces with concurrent single requests in the same
        pipelined dispatcher.
        """
        t0 = time.perf_counter()
        try:
            body = json.loads(self._body() or b"{}")
        except ValueError:
            return self._respond(400, {"error": "invalid JSON body"})
        queries = body.get("queries")
        if not isinstance(queries, list) or not queries:
            return self._respond(400, {"error": "missing queries list"})
        if len(queries) > 4096:
            return self._respond(400, {"error": "too many queries (max 4096)"})
        # Per-item validation with error isolation: a malformed item gets an
        # error object in ITS slot; the rest of the batch still runs. `k`
        # parses with the same stoi() semantics as every GET route ("10abc"
        # -> 10; floats truncate like the reference's int cast).
        out: list = [None] * len(queries)
        reqs = []
        positions = []
        for i, item in enumerate(queries):
            if not isinstance(item, dict) or "q" not in item:
                out[i] = {"error": "each query needs q"}
                continue
            k_raw = item.get("k", 10)
            try:
                k = stoi(k_raw) if isinstance(k_raw, str) else int(k_raw)
            except (ValueError, TypeError):
                out[i] = {"error": "invalid k param", "q": str(item["q"])}
                continue
            reqs.append((str(item["q"]), k))
            positions.append(i)
        searched = self.ctx.batcher.search_many(reqs) if reqs else []
        for i, j in zip(positions, searched):
            out[i] = j
        results = out
        ms = (time.perf_counter() - t0) * 1000.0
        self.ctx.stats.increment_searches(len(searched))
        # Assemble the response as bytes: native-rendered items are already
        # compact JSON fragments (the "cached" flag splices in before the
        # closing brace); dict items (cache-restored, early-return, error
        # slots) serialize individually.
        n_cached = 0
        parts = []
        for j in results:
            if hasattr(j, "fragment"):  # caches.Rendered
                if j.cached:
                    n_cached += 1
                    parts.append(j.fragment[:-1] + b',"cached":true}')
                else:
                    parts.append(j.fragment[:-1] + b',"cached":false}')
            else:
                if j.pop("from_cache", None):
                    j["cached"] = True
                    n_cached += 1
                elif "error" not in j:
                    j["cached"] = False
                parts.append(
                    json.dumps(j, separators=(",", ":")).encode("utf-8")
                )
        if n_cached:
            self.ctx.stats.increment_search_cache_hits(n_cached)
        log("search", f"batch n={len(results)} {ms:.1f}ms")
        body = (
            b'{"results":[' + b",".join(parts)
            + b'],"search_time_ms":' + repr(ms).encode() + b"}"
        )
        self._respond(200, None, raw=body)

    def _handle_suggest(self):
        params = self._params()
        if "q" not in params:
            return self._respond(400, {"error": "missing q param"})
        q = params["q"]
        k = stoi(params["k"]) if "k" in params else 5
        ac_cfg = self.ctx.config.autocomplete
        L = max(ac_cfg.limit_min, min(int(k), ac_cfg.limit_max))
        suggestions = self.ctx.suggest_batcher.suggest(q, L)
        self._respond(
            200, {"query": q, "limit": L, "suggestions": suggestions}
        )

    def _handle_reload(self):
        # warm=True: pin + compile the NEW index's envelopes before the
        # atomic swap (compiles hit the persistent cache), so serving never
        # sees an unwarmed index. Searches keep running on the old index for
        # the whole build — reload() only takes engine.mtx for the swap.
        warm = os.environ.get("NEXTSEARCH_WARMUP", "1") == "1"
        ok = self.ctx.engine.reload(warm=warm)
        self._respond(
            200, {"reloaded": ok, "segments": len(self.ctx.engine.seg_names)}
        )

    def _handle_stats(self):
        stats = self.ctx.stats.get_stats_json(self.ctx.feedback)
        # extension: ?timings=1 adds framework span timings + index info
        if self._params().get("timings") == "1":
            from ..utils.profiling import GLOBAL_TRACER

            stats["engine_timings"] = GLOBAL_TRACER.report()
            idx = self.ctx.engine.index
            if idx is not None:
                stats["index"] = {
                    "segments": len(self.ctx.engine.seg_names),
                    "docs": idx.n_docs,
                    "postings": getattr(idx, "n_postings", None),
                    "dense_rows": getattr(idx, "n_dense", None),
                    "doc_slots": getattr(idx, "n_slots", None),
                }
                if hasattr(idx, "hbm_bytes"):
                    stats["index"]["hbm_bytes"] = idx.hbm_bytes()
        self._respond(200, stats)

    def _handle_feedback(self):
        status, payload = validate_and_add(self.ctx.feedback, self._body())
        self._respond(status, payload)

    def _handle_ai_overview(self):
        if not self.ctx.azure.enabled:
            return self._respond(
                503,
                {
                    "error": "Azure OpenAI not configured. Please set "
                    "AZURE_OPENAI_ENDPOINT, AZURE_OPENAI_API_KEY, and "
                    "AZURE_OPENAI_MODEL in .env file"
                },
            )
        params = self._params()
        if "q" not in params:
            return self._respond(400, {"error": "missing q param"})
        query = params["q"]
        k = stoi(params["k"]) if "k" in params else 10

        # Retry/backoff loop for a parallel /api/search filling the cache
        # (reference src/api_server.cpp:243-269).
        search_results = None
        for retry in range(10):
            search_results = self.ctx.engine.search(query, k)
            if search_results.get("from_cache"):
                break
            if search_results.get("results"):
                break
            if retry < 9:
                time.sleep(0.05)
        if not search_results or not search_results.get("results"):
            return self._respond(
                404,
                {"error": "No search results found for the query", "query": query},
            )

        ai = generate_ai_overview(
            self.ctx.azure, query, k, search_results,
            engine=self.ctx.engine, stats=self.ctx.stats,
            is_authorized=False, transport=self.ctx.transport,
        )
        response = {"query": query}
        if ai.get("success"):
            response["overview"] = ai.get("overview")
            response["model"] = ai.get("model")
            if "usage" in ai:
                response["usage"] = ai["usage"]
            return self._respond(200, response)
        response["error"] = ai.get("error", "Unknown error")
        if "details" in ai:
            response["details"] = ai["details"]
        return self._respond(500, response)

    def _handle_ai_summary(self):
        if not self.ctx.azure.enabled:
            return self._respond(
                503,
                {
                    "error": "Azure OpenAI not configured. Please set "
                    "AZURE_OPENAI_ENDPOINT, AZURE_OPENAI_API_KEY, and "
                    "AZURE_OPENAI_MODEL in .env file"
                },
            )
        params = self._params()
        if "cord_uid" not in params:
            return self._respond(400, {"error": "missing cord_uid param"})
        cord_uid = params["cord_uid"]

        ai = generate_ai_summary(
            self.ctx.azure, cord_uid,
            engine=self.ctx.engine, stats=self.ctx.stats,
            is_authorized=False, transport=self.ctx.transport,
        )
        if ai.get("success"):
            response = {"cord_uid": ai.get("cord_uid"), "summary": ai.get("summary")}
            if "cached" in ai:
                response["cached"] = ai["cached"]
            return self._respond(200, response)
        # reference quirk: any error carrying cord_uid -> 404, else 500
        status = 404 if "cord_uid" in ai else 500
        response = {"cord_uid": cord_uid, "error": ai.get("error", "Unknown error")}
        if "details" in ai:
            response["details"] = ai["details"]
        return self._respond(status, response)

    def _handle_add_document(self):
        if not self.ctx.enable_add_document:
            # reference src/api_add_document.cpp:536-541 (hard-disabled)
            return self._respond(
                503,
                {"error": '"Add Document" is disabled for the current version'},
            )
        from .add_document import handle_add_document

        status, payload = handle_add_document(self.ctx, self.headers, self._body())
        return self._respond(status, payload)


def make_server(ctx: ServerContext, host: str = "0.0.0.0", port: int = 8080):
    handler = type("BoundApiHandler", (ApiHandler,), {"ctx": ctx})
    return ThreadingHTTPServer((host, port), handler)


def main(argv=None):
    argv = list(argv) if argv is not None else sys.argv[1:]

    # --mesh dp,seg: serve from a ShardedIndex over a (dp, seg) device mesh
    # (multi-chip deployment mode; segments shard over the seg axis, query
    # batches over dp). Without it the engine runs single-device.
    mesh_shape = None
    if "--mesh" in argv:
        i = argv.index("--mesh")
        try:
            dp_s, seg_s = argv[i + 1].split(",")
            mesh_shape = (int(dp_s), int(seg_s))
        except (IndexError, ValueError):
            print("--mesh expects 'dp,seg' (e.g. --mesh 2,4)", file=sys.stderr)
            return 1
        del argv[i : i + 2]

    # --mode: device execution mode (config.DeviceConfig.mode). "sparse" is
    # the scatter-free kernel tuned for 1M+-doc corpora; "fused" (default)
    # wins at smaller scales. Also honored: NEXTSEARCH_MODE env var.
    mode = os.environ.get("NEXTSEARCH_MODE")
    if "--mode" in argv:
        i = argv.index("--mode")
        try:
            mode = argv[i + 1]
        except IndexError:
            print("--mode expects one of fused|sparse|exact|fast", file=sys.stderr)
            return 1
        del argv[i : i + 2]
    if mode is not None and mode not in ("fused", "sparse", "exact", "fast"):
        print(f"unknown --mode '{mode}' (fused|sparse|exact|fast)", file=sys.stderr)
        return 1

    if not argv:
        print(
            "Usage: python -m nextsearch.api.server <INDEX_DIR> [port] "
            "[--mesh dp,seg] [--mode fused|sparse|exact|fast]\n"
            "Example: python -m nextsearch.api.server ./index 8080",
            file=sys.stderr,
        )
        return 1
    index_dir = Path(argv[0])
    port = int(argv[1]) if len(argv) > 1 else 8080

    mesh = None
    if mesh_shape is not None:
        from ..parallel.mesh import make_mesh

        mesh = make_mesh(dp=mesh_shape[0], seg=mesh_shape[1])
        log("server", f"serving over mesh (dp={mesh_shape[0]}, seg={mesh_shape[1]})")

    from dataclasses import replace

    config = DEFAULT_CONFIG
    if mode is not None:
        config = replace(config, device=replace(config.device, mode=mode))
        log("server", f"device execution mode: {mode}")

    # Memory/throughput operating point: dense-row device-memory budget +
    # classification ratio, overridable per deployment. Defaults
    # match DeviceConfig (2 GiB rows); the bench's throughput headline
    # runs 7 GiB.
    dev = config.device
    dev = replace(
        dev,
        dense_max_bytes=int(
            os.environ.get("NEXTSEARCH_DENSE_BYTES", dev.dense_max_bytes)
        ),
        dense_df_ratio=float(
            os.environ.get("NEXTSEARCH_DENSE_RATIO", dev.dense_df_ratio)
        ),
        heavy_buckets=tuple(
            int(x)
            for x in os.environ.get(
                "NEXTSEARCH_HEAVY_BUCKETS",
                ",".join(str(b) for b in dev.heavy_buckets),
            ).split(",")
        ),
        posting_block=int(
            os.environ.get("NEXTSEARCH_POSTING_BLOCK", dev.posting_block)
        ),
    )
    if dev != config.device:
        config = replace(config, device=dev)
        log("server", f"device budgets: dense_bytes={dev.dense_max_bytes} "
            f"ratio={dev.dense_df_ratio:.6f} buckets={dev.heavy_buckets}")

    # Native C++ JSON render of search responses (default on; the Python
    # dict render is the fallback and the parity reference). Rendered
    # fragments flow through the caches and the batch route untouched.
    if os.environ.get("NEXTSEARCH_NATIVE_RENDER", "1") == "1":
        from .. import native as _native

        if _native.available():
            config = replace(config, native_render=True)
            log("server", "native batch-response renderer enabled")

    # Serving persistence: write-behind (bounded staleness) instead of the
    # reference's write-per-update — a full cache/stats JSON dump per
    # request is a hard QPS ceiling on the host CPU. Set *_FLUSH_MS=0 for
    # strict reference-parity persistence.
    cache_flush = float(os.environ.get("NEXTSEARCH_CACHE_FLUSH_MS", 1000))
    if cache_flush != config.cache.flush_ms:
        config = replace(config, cache=replace(config.cache, flush_ms=cache_flush))

    # Serving-batch shape knobs (the bench's throughput point runs batch 512
    # depth 2; the BatchingConfig default of 256 favors latency).
    bat = config.batching
    bat = replace(
        bat,
        max_batch=int(os.environ.get("NEXTSEARCH_MAX_BATCH", bat.max_batch)),
        window_ms=float(os.environ.get("NEXTSEARCH_WINDOW_MS", bat.window_ms)),
        pipeline_depth=int(
            os.environ.get("NEXTSEARCH_PIPELINE_DEPTH", bat.pipeline_depth)
        ),
        small_batch=int(
            os.environ.get("NEXTSEARCH_SMALL_BATCH", bat.small_batch)
        ),
        small_window_ms=float(
            os.environ.get("NEXTSEARCH_SMALL_WINDOW_MS", bat.small_window_ms)
        ),
    )
    if bat != config.batching:
        config = replace(config, batching=bat)
        log("server", f"batching: max_batch={bat.max_batch} "
            f"window_ms={bat.window_ms} depth={bat.pipeline_depth}")

    # Persistent XLA compile cache (bench.py does the same), enabled BEFORE
    # the first compile (reload's device-build kernels): warmup's envelope
    # compiles then survive server restarts — cold start pays them once per
    # config, not once per boot.
    from ..utils.compilecache import enable_compilation_cache

    enable_compilation_cache()

    engine = Engine(index_dir, mesh=mesh, config=config)
    t0 = time.perf_counter()
    if not engine.reload():
        log("server", f"Failed to load index segments from: {index_dir}", level="error")
        return 1
    log("server", f"reload (load + device build/upload) took "
        f"{time.perf_counter() - t0:.1f}s")

    env_vars = load_env_file(".env")
    azure = AzureOpenAIConfig(
        endpoint=env_vars.get("AZURE_OPENAI_ENDPOINT", ""),
        api_key=env_vars.get("AZURE_OPENAI_API_KEY", ""),
        model=env_vars.get("AZURE_OPENAI_MODEL", ""),
    )
    stats = StatsTracker(
        flush_ms=float(os.environ.get("NEXTSEARCH_STATS_FLUSH_MS", 200))
    )
    if not Path("stats.json").exists() and env_vars.get("AI_API_CALLS_LIMIT"):
        limit = int(env_vars["AI_API_CALLS_LIMIT"])
        stats.set_ai_api_calls_limit(limit)
        log("stats", f"AI API calls limit set to: {limit} (from .env)")
    if azure.enabled:
        log("azure", f"Azure OpenAI enabled with model: {azure.model}")
    else:
        log("azure", "Azure OpenAI not configured "
            "(AI overview endpoint will return error)")
    feedback = FeedbackManager("feedback.json")
    if os.environ.get("NEXTSEARCH_WARMUP", "1") == "1":
        # NEXTSEARCH_WARMUP_SIZES="1,512": warm only those batch-size
        # envelopes (each is a probe + XLA compile on first run; cached
        # after). Default warms the full Q
        # ladder so any coalesced batch size hits a compiled shape.
        sizes_env = os.environ.get("NEXTSEARCH_WARMUP_SIZES")
        t0 = time.perf_counter()
        engine.warmup(
            sizes=[int(s) for s in sizes_env.split(",")] if sizes_env else None
        )
        log("server", f"warmup took {time.perf_counter() - t0:.1f}s")
    ctx = ServerContext(
        engine, stats, feedback, azure, config=config,
        enable_add_document=os.environ.get("NEXTSEARCH_ENABLE_ADD_DOCUMENT") == "1",
    )
    server = make_server(ctx, port=port)
    print(f"API running on http://127.0.0.1:{port}")
    print("Try: /api/search?q=mycoplasma+pneumonia&k=10")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        engine.save_caches()
        stats.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
