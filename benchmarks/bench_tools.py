"""QPS-at-parity on the TOOLS-BUILT 1M index.

The index at NEXTSEARCH_TOOLS_ROOT (default <repo>/.bench_cache/tools_1m)
is built end-to-end by the product CLI pipeline (tools/make_synthetic ->
tools/forwardindex -> tools/lexicon); this harness measures reload time,
pins, guard-trip rate, and pipelined QPS at exact parity on it — the df
profile of tokenized text is the corpus closest to the north star's
"~1M CORD-19 docs". Build it with: bash benchmarks/build_tools_index.sh
Fails without a GPU; prints the device and the card beside its numbers.
"""
import sys, time, os
from pathlib import Path
REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
from nextsearch.utils.compilecache import enable_compilation_cache
from nextsearch.utils.device import card_line, require_gpu
enable_compilation_cache()
print(f"device {require_gpu()} card {card_line()}", flush=True)
import numpy as np
from nextsearch.config import DeviceConfig, EngineConfig
from nextsearch.index.segment import DeviceIndex
from nextsearch.index.artifacts import load_segment_cached

t0 = time.time()
root = os.environ.get("NEXTSEARCH_TOOLS_ROOT",
                      str(REPO / ".bench_cache" / "tools_1m"))
seg = load_segment_cached(root + "/index/segments/seg_000001")
print(f"segment load (binary->artifact) {time.time()-t0:.1f}s: "
      f"{seg.N} docs, {len(seg.terms)} terms, {seg.num_postings} postings", flush=True)
# Defaults for tokenized-text df profiles: 8 GiB dense rows (room next to
# two in-flight f32 H buffers), a 2^10-granularity light table (1 GiB) and
# a high host-rescue cap (host rescues are memoized; a relaunch would need
# room for the full-table exact kernel). Not yet measured on the GPU.
os.environ.setdefault("NEXTSEARCH_TRIP_RESCUE", "64")
os.environ.setdefault("NEXTSEARCH_LIGHT_TABLE_BYTES", str(1 << 30))
cfg = EngineConfig(device=DeviceConfig(
    mode="sparse",
    posting_block=int(os.environ.get("NEXTSEARCH_POSTING_BLOCK", 64)),
    heavy_buckets=(512,),
    dense_df_ratio=float(os.environ.get("NEXTSEARCH_DENSE_RATIO", 1/1024)),
    dense_max_bytes=int(os.environ.get("NEXTSEARCH_DENSE_BYTES", 8<<30))))
t0 = time.time()
di = DeviceIndex([seg], config=cfg)
print(f"index build {time.time()-t0:.1f}s", flush=True)

# df-weighted query stream over the REAL lexicon (same Zipf-popularity
# model as the synthetic bench)
dfs = seg.term_df.astype(np.float64)
cum = np.cumsum(dfs / dfs.sum()); cum[-1] = 1.0
rng = np.random.default_rng(7)
def mk_batch(n):
    out = []
    for _ in range(n):
        w = int(rng.integers(1, 5))
        picks = np.searchsorted(cum, rng.random(w), "right")
        while len(set(picks.tolist())) != w:
            picks = np.searchsorted(cum, rng.random(w), "right")
        out.append([(seg.terms[int(t)], 1.0) for t in picks])
    return out
batches = [mk_batch(512) for _ in range(40)]
t0 = time.time()
pins = di.pin_shapes(batches[:16], scope_q=True)
print(f"pins {pins} ({time.time()-t0:.1f}s)", flush=True)
t0 = time.time(); di.search_batch(batches[0], k=10)
print(f"warm {time.time()-t0:.1f}s", flush=True)

# parity gate vs oracle
from nextsearch.index.oracle import oracle_search
osegs = [seg.to_oracle_segment()]
for terms, res in zip(batches[1][:8], di.search_batch(batches[1][:8], k=10)):
    hits, found = oracle_search(osegs, terms, k=10)
    assert res.found == found, (terms, res.found, found)
    for (o_s, _sg, o_d), d_s, d_slot in zip(hits, res.scores, res.doc_slots):
        assert di.locate(int(d_slot))[1] == o_d, terms
        assert np.float32(d_s) == np.float32(o_s), terms
print("parity: OK (8 queries exact)", flush=True)

secs = float(os.environ.get("NEXTSEARCH_TOOLS_SECS", 12))
n, i, t0, window = 0, 0, time.time(), []
while time.time() - t0 < secs or not n:
    window.append(di.search_batch_async(batches[i % len(batches)], k=10))
    if len(window) > 2:
        di.search_batch_gather(window.pop(0)); n += 512
    i += 1
while window:
    di.search_batch_gather(window.pop(0)); n += 512
wall = time.time() - t0
qps = n / wall
print(f"TOOLS-BUILT 1M: qps={qps:.0f}  batches={n//512} "
      f"trips={di.rescue_trips} rescue_ms_total={di.rescue_ms:.0f} "
      f"({di.rescue_ms / max(n // 512, 1):.1f} ms/batch of "
      f"{wall * 1000 / max(n // 512, 1):.1f})", flush=True)
