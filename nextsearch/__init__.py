"""nextsearch — a BM25 search-engine framework on an accelerator (JAX/XLA).

A JAX framework with the capabilities of the NextSearch C++ reference engine
(see SURVEY.md): segmented inverted-index construction, batched BM25 query
execution on the GPU with fused top-k, device-side autocomplete
prefix scans, semantic query expansion via dense matmul, and the full HTTP API
surface (search / suggest / ai_overview / ai_summary / feedback / stats /
reload / add_document) with LRU result caching and lazy metadata gathers.

Layout:
  utils/     tokenizer, CORD JSON extraction, .env loader, CSV parity parsers
  index/     build pipeline, segment artifacts, binary segment IO, oracle
  ops/       jit compute: BM25 scoring, top-k, prefix scan, dense matmul
  parallel/  device mesh + shard_map multi-segment execution and score merge
  models/    retrieval models: BM25, semantic expansion, autocomplete, hybrid
  api/       HTTP server, caches, stats, feedback, AI proxy, request batching
  tools/     CLI: forwardindex, lexicon, adddocument, slice_cord19, backup
  native/    optional C++ acceleration (tokenizer, CSV scan) via ctypes
"""

__version__ = "0.1.0"
