"""Typed configuration for the whole framework.

Every tunable that matters for parity with the reference is carried here with
the reference's hard-coded default (citations per field). On top of those we
add the device-execution knobs: mesh axes, query batching, posting block size.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class BM25Config:
    # src/api_engine.cpp:375-376
    k1: float = 1.2
    b: float = 0.75
    # k clamp 1..100: src/api_engine.cpp:377
    k_min: int = 1
    k_max: int = 100


@dataclass(frozen=True)
class ExpansionConfig:
    # src/api_engine.cpp:411-417
    per_term: int = 3
    global_topk: int = 5
    min_sim: float = 0.55
    alpha: float = 0.6
    max_total_terms: int = 40


@dataclass(frozen=True)
class AutocompleteConfig:
    # suggest limit clamp 1..10: src/api_engine.cpp:171
    limit_min: int = 1
    limit_max: int = 10
    # top candidates per prefix: src/api_engine.cpp:108
    max_candidates: int = 10


@dataclass(frozen=True)
class CacheConfig:
    # include/api_engine.hpp:42-60
    search_capacity: int = 2600
    ai_overview_capacity: int = 500
    ai_summary_capacity: int = 1000
    save_interval: int = 1
    # 0 = write-through on every save_interval-th put (reference parity);
    # >0 = write-behind, persisted at most once per flush_ms by a daemon
    # thread (the serving front sets this: a full cache JSON dump per put
    # is a ~100 puts/s ceiling on a 1-core host).
    flush_ms: float = 0.0


@dataclass(frozen=True)
class DeviceConfig:
    """Device execution knobs (no reference counterpart — ours)."""

    # Queries scored per kernel launch; concurrent API requests are batched
    # up to this size (replaces the reference's engine-wide mutex).
    max_query_batch: int = 64
    # Max weighted terms per query after expansion (ExpansionConfig caps at 40).
    max_terms: int = 40
    # Posting gather tile; per-term postings are processed in L-sized windows.
    posting_block: int = 2048
    # Pad doc axis of per-segment score vectors to a multiple of this.
    # 2048 keeps n_slots divisible by the tiled_topk tile width.
    doc_pad: int = 2048
    # Execution mode:
    #   "fused"  one scatter-add over all (query, term) chunks + exact f32
    #            rescore of the top candidates (default; ~1000x faster than
    #            "exact" at scale, reported scores still bit-exact)
    #   "exact"  sequential per-term-slot scatters — the C++ engine's f32
    #            accumulation order end to end (parity oracle mode)
    #   "fast"   one scatter, no rescore (scores may differ in the last ULP)
    #   "sparse" no scatter at all: light terms via sort + segmented sum,
    #            heavy terms via one matmul plus per-tile maxima and hit
    #            counts; exact rescore reads heavy contributions off the
    #            dense rows (see ops/bm25_sparse.py)
    mode: str = "fused"
    # Candidate margin for the fused rescore pass (actual K2 = max(2K, this)).
    rescore_margin: int = 32
    # Hybrid posting representation: terms with df >= n_slots * this ratio
    # get a precomputed DENSE score row; query-time contribution is then one
    # matmul over the batch's unique heavy rows instead of a scatter of
    # huge posting lists. 0 disables dense rows. Lower ratios trade device
    # memory (dense_max_bytes) for fewer light postings per query.
    dense_df_ratio: float = 1 / 256
    # Caps on dense rows (highest-df terms win); bound device memory. The byte
    # cap dominates at large corpora: rows = dense_max_bytes / (4 * n_slots).
    dense_max_rows: int = 4096
    dense_max_bytes: int = 2 << 30
    # Unique-heavy-row buckets per batch (static matmul shapes).
    heavy_buckets: Tuple[int, ...] = (8, 32, 128, 256)
    # Precomputed exact top-k per head dense row (sparse + f32 rows): a
    # single-heavy-term query's top-k is a pure function of its row, so
    # the engine answers those queries host-side from this table — zero
    # device work, zero fast-path guard trips. Trips otherwise cluster on
    # df~N terms whose 10th..K2th scores sit inside the bf16 selection
    # error band, where the guard provably cannot pass (measured: every
    # EVAL config-3 trip was the rank-1 Zipf term as a 1-term query).
    # Only the top `row_topk_rows` rows (df-descending) pay the build-time
    # sort; 0 disables either way.
    row_topk_k: int = 128
    row_topk_rows: int = 256
    # Precomputed exact canonical top-k per LIGHT (term, segment) posting
    # range (sparse mode): a single-light-term query is a pure function of
    # its posting list(s), so the engine answers those host-side too —
    # and, because pin_shapes' workload probe skips shortcut-eligible
    # queries, the C/L2 chunk budgets (= the light chain's gather/sort
    # volume, wall time at scale) shrink by those queries' postings.
    # Serving k > light_topk_k falls back to the kernel via a bounded,
    # logged escape shape. 0 disables.
    light_topk_k: int = 32
    # bf16 dense score accumulation: halves [Q, n_slots] traffic. Reported
    # scores stay bit-exact (f32 rescore) and `found` stays exact; only the
    # K2-candidate preselection sees ~0.4% relative noise (guarded by the
    # 2K margin).
    scores_bf16: bool = False
    # Store dense rows in bf16: halves their memory residency (2x more rows per
    # dense_max_bytes) and the per-batch matmul read. OFF by default: bf16
    # rounding collapses near-uniform heavy-term scores into false ties,
    # and a K2-wide candidate pool can then exclude true top-K docs
    # (measured on a df=N term whose per-doc scores differ only in the
    # 4th significant digit). f32 rows keep selection faithful: distinct
    # eager scores stay distinct, exact ties break doc-asc consistently
    # with the canonical order.
    dense_rows_bf16: bool = False
    # Sparse-mode unified-totals pipeline (ops/bm25_sparse.
    # bm25_search_sparse_unified): add light contributions INTO the heavy
    # matmul output (scatter-add of doc-sorted entries) and read selection
    # maxima + the exact matched-doc count off one totals matrix, instead
    # of the split path's H-gather at light lanes and light selection
    # sort. Composes with fast_heavy (trips relaunch the exact wide PACKED
    # kernel). Requires compact heavy mode (single-launch batches only;
    # launch groups keep the packed kernel). OFF: not measured on the GPU.
    unified: bool = False
    # Guarded fast path (sparse + f32 rows): heavy matmul in TF32 over
    # TF32-rounded operands (ops/heavy.heavy_matmul) and ONE merged
    # K2-wide candidate pool (half the rescore gathers). The kernel emits
    # a per-query proof that the approximations could not have changed
    # the top-K (exact K-th rescored score > (1+eps) * the selection
    # threshold); when the proof fails — near-uniform score plateaus —
    # the engine rescues those queries on the host or relaunches the
    # exact f32 wide-pool kernel, so reported results are ALWAYS
    # bit-exact. eps bounds the TF32 product's relative error: each
    # rounded operand is within 2^-11, so a product of non-negative terms
    # is within 2 * 2^-11 ~= 9.8e-4 (2^-11 ~= 4.9e-4 when query weights
    # are exact in TF32, as unit weights are); 2e-3 keeps 2x over the
    # worst case.
    fast_heavy: bool = True
    fast_heavy_eps: float = 2e-3
    # Multi-launch group size (sparse mode): a batch larger than this is
    # split into block-diagonal sub-batches that run through ONE device
    # launch (bm25_search_sparse_packed_multi), paying one host round trip
    # instead of G; sub-batches keep their own compact-U mix and chunk
    # budget, so per-query device cost matches the single-batch kernel (a
    # monolithic 2x batch references more distinct heavy rows and scales
    # the matmul per query). Not measured on the GPU. 0 disables.
    launch_group: int = 512
    # Fixed chunk-count buckets for the fused/fast scatter (per batch).
    # Gather volume beyond the live chunks is pure waste, so the ladder
    # starts small; each bucket is one XLA compile (cached persistently).
    chunk_buckets: Tuple[int, ...] = (256, 1024, 4096, 16384, 65536)
    # Mesh axis names: dp shards the query batch, seg shards index segments.
    mesh_axes: Tuple[str, str] = ("dp", "seg")


@dataclass(frozen=True)
class HybridConfig:
    """Hybrid BM25 + dense rerank (ours; BASELINE config 5)."""

    beta: float = 0.5
    candidates: int = 100


@dataclass(frozen=True)
class BatchingConfig:
    """Request-batching queue for the API front (replaces the global mutex)."""

    # Large batches amortize per-launch overhead; the window only adds
    # latency when traffic is sparse.
    max_batch: int = 256
    # How long the dispatcher waits to coalesce concurrent requests.
    window_ms: float = 2.0
    # Launches kept in flight by the serving dispatcher: batch N+1 is
    # planned+launched before batch N is gathered, hiding host planning
    # and the host<->device round trip behind device exec. 2 matches the
    # bench harness.
    pipeline_depth: int = 2
    # Adaptive operating point (VERDICT r4 item 10): when the queue is
    # shallow the dispatcher closes the window after `small_batch`
    # requests / `small_window_ms`, landing on the small warmed Q
    # envelope (interactive p50); a deep queue keeps the full
    # max_batch/window_ms throughput point. Both envelopes are pinned and
    # compiled by Engine.warmup's default ladder. small_batch=0 disables.
    small_batch: int = 64
    small_window_ms: float = 0.5


@dataclass(frozen=True)
class EngineConfig:
    bm25: BM25Config = field(default_factory=BM25Config)
    expansion: ExpansionConfig = field(default_factory=ExpansionConfig)
    autocomplete: AutocompleteConfig = field(default_factory=AutocompleteConfig)
    cache: CacheConfig = field(default_factory=CacheConfig)
    device: DeviceConfig = field(default_factory=DeviceConfig)
    batching: BatchingConfig = field(default_factory=BatchingConfig)
    hybrid: HybridConfig = field(default_factory=HybridConfig)
    # Native C++ JSON render of per-query search responses (serving path;
    # native/render_native.cpp). Off by default: search_batch then returns
    # the reference dict shapes. The server turns it on (env
    # NEXTSEARCH_NATIVE_RENDER) — results come back as caches.Rendered
    # fragments, skipping the per-result Python dict render + json.dumps.
    native_render: bool = False


DEFAULT_CONFIG = EngineConfig()
