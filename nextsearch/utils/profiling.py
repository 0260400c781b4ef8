"""Tracing and profiling utilities.

The reference's tracing is steady_clock spans around search surfaced as
response timing fields (src/api_server.cpp:120-175) — those fields are kept
by api/server.py. This module adds the framework-level layer promised in
SURVEY.md §5: aggregated span timings (per-phase p50/total) and optional XLA
profiler trace capture.

Env: NEXTSEARCH_PROFILE_DIR=<dir> enables jax.profiler traces around device
calls (view with TensorBoard / xprof).
"""

from __future__ import annotations

import os
import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List


class Tracer:
    """Thread-safe named-span aggregator ([tag] -> count/total/p50)."""

    def __init__(self, keep: int = 512):
        self._lock = threading.Lock()
        self._samples: Dict[str, List[float]] = defaultdict(list)
        self._counts: Dict[str, int] = defaultdict(int)
        self._totals: Dict[str, float] = defaultdict(float)
        self._keep = keep

    @contextmanager
    def span(self, tag: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self._counts[tag] += 1
                self._totals[tag] += dt
                s = self._samples[tag]
                s.append(dt)
                if len(s) > self._keep:
                    del s[: len(s) - self._keep]

    def record(self, tag: str, seconds: float) -> None:
        with self._lock:
            self._counts[tag] += 1
            self._totals[tag] += seconds
            s = self._samples[tag]
            s.append(seconds)
            if len(s) > self._keep:
                del s[: len(s) - self._keep]

    def report(self) -> Dict[str, dict]:
        with self._lock:
            out = {}
            for tag, n in self._counts.items():
                s = sorted(self._samples[tag])
                p50 = s[len(s) // 2] if s else 0.0
                p99 = s[min(len(s) - 1, int(len(s) * 0.99))] if s else 0.0
                out[tag] = {
                    "count": n,
                    "total_ms": round(self._totals[tag] * 1000, 3),
                    "p50_ms": round(p50 * 1000, 3),
                    "p99_ms": round(p99 * 1000, 3),
                }
            return out

    def reset(self) -> None:
        with self._lock:
            self._samples.clear()
            self._counts.clear()
            self._totals.clear()


GLOBAL_TRACER = Tracer()


@contextmanager
def device_trace(tag: str = "trace"):
    """jax.profiler trace when NEXTSEARCH_PROFILE_DIR is set; no-op else."""
    profile_dir = os.environ.get("NEXTSEARCH_PROFILE_DIR")
    if not profile_dir:
        yield
        return
    import jax

    with jax.profiler.trace(os.path.join(profile_dir, tag)):
        yield


def device_op_times(trace_dir: str, plane_prefix: str = "/device:GPU"):
    """Device time by op from the newest jax.profiler trace in trace_dir.

    Returns {(line name, event name): [total_ns, count]} summed over the
    planes whose name starts with plane_prefix (one plane per card).
    """
    import glob

    from jax.profiler import ProfileData

    files = sorted(
        glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                  recursive=True),
        key=os.path.getmtime,
    )
    if not files:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    out: Dict[tuple, list] = defaultdict(lambda: [0, 0])
    for plane in ProfileData.from_file(files[-1]).planes:
        if not plane.name.startswith(plane_prefix):
            continue
        for line in plane.lines:
            for ev in line.events:
                acc = out[(line.name, ev.name)]
                acc[0] += int(ev.duration_ns)
                acc[1] += 1
    return dict(out)
