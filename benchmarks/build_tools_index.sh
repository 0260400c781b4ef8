#!/bin/bash
# Tools-built 1M index: the REAL product pipeline, into .bench_cache/
set -e
cd "$(dirname "$0")/.."
ROOT=${NEXTSEARCH_TOOLS_ROOT:-.bench_cache/tools_1m}
if [ ! -f $ROOT/index/segments/seg_000001/barrels.bin ]; then
  mkdir -p $ROOT
  echo "[tools] make_synthetic..." >&2
  python -m nextsearch.tools.make_synthetic $ROOT/corpus --n 1000000 --vocab 200000 --seed 4
  mkdir -p $ROOT/index/segments/seg_000001
  echo "[tools] forwardindex..." >&2
  python -m nextsearch.tools.forwardindex $ROOT/corpus $ROOT/index/segments/seg_000001
  echo "[tools] lexicon..." >&2
  python -m nextsearch.tools.lexicon $ROOT/index/segments/seg_000001
fi
echo "[tools] done" >&2
ls -la $ROOT/index/segments/seg_000001 | head -5
