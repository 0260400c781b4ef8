"""Autocomplete over a device-side sorted term table.

Behavioral parity with the reference trie (src/api_autocomplete.cpp):
  - candidate terms are the normalized lexicon terms with len >= 2; score is
    the document frequency summed across segments (src/api_engine.cpp:92-108)
  - ranking is (score desc, term asc) (src/api_autocomplete.cpp:48-51)
  - only the last alphanumeric run of the user input is completed; everything
    before it ("base") is preserved verbatim (src/api_autocomplete.cpp:154-190)
  - at most 10 candidates per prefix (build) and limit clamps to 1..10

Device mechanism: terms sorted lexicographically; a prefix is a
contiguous [lo, hi) range found by host binary search; the device ranks the
range with a masked top-k over the score vector (ops/prefix.py). Lookups are
batchable across concurrent API requests.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..utils.textutil import normalize_token


def _is_ascii_alnum(ch: str) -> bool:
    return ch.isascii() and ch.isalnum()


def split_last_token(user_input: str) -> tuple[str, str]:
    """(base, last_token): last ASCII-alnum run + the preserved prefix.

    Trailing non-alnum characters are dropped (reference :161-169).
    """
    n = len(user_input)
    end = n
    while end > 0 and not _is_ascii_alnum(user_input[end - 1]):
        end -= 1
    start = end
    while start > 0 and _is_ascii_alnum(user_input[start - 1]):
        start -= 1
    return user_input[:start], user_input[start:end]


class AutocompleteIndex:
    """Sorted term table + device score vector, built from term->score.

    Short prefixes (len <= PRECOMP_LEN) are served from a per-prefix top-k
    cache built vectorized at load — the device-side analog of the reference
    trie's per-node top-10 (src/api_autocomplete.cpp:58-86): at a 500k-term
    vocabulary the full-table masked top-k would scan Q x 500k per launch,
    while short prefixes are exactly the wide ranges. Long prefixes cover
    narrow sorted-table ranges and go to the windowed device kernel.
    """

    # Prefix lengths served from the precomputed per-prefix cache. 5 (was
    # 4 through r3) covers the len-5 band of a typing-user workload (~10%
    # of suggests) host-side; build cost is one more vectorized lexsort
    # pass, memory one more [groups, K] table (~25 MB at 719k terms).
    PRECOMP_LEN = 5
    WINDOW_BUCKETS = (256, 2048, 16384)
    # Ranges at or below this answer host-side with a partial sort
    # (microseconds, no device launch).
    NARROW_RANGE = 4096

    def __init__(self):
        self.terms: List[str] = []
        self._scores_dev = None
        self._pad = 0
        self._pref_starts: Dict[int, np.ndarray] = {}
        self._pref_cands: Dict[int, np.ndarray] = {}

    def build(
        self,
        term_to_score: Dict[str, int],
        max_candidates_per_prefix: int = 10,
    ) -> None:
        import jax.numpy as jnp

        self.max_top = max(1, int(max_candidates_per_prefix))
        items: Dict[str, int] = {}
        for raw, score in term_to_score.items():
            t = normalize_token(raw)
            if len(t) < 2:
                continue
            # normalized collisions keep the max score (reference update_top
            # dedup keeps the higher score, :33-47)
            prev = items.get(t)
            if prev is None or score > prev:
                items[t] = int(score)
        self.terms = sorted(items)
        scores = np.fromiter(
            (items[t] for t in self.terms), np.int32, count=len(self.terms)
        )
        # pad to a lane multiple with -1 (never ranks above real scores >= 1)
        T = max(128, ((len(scores) + 127) // 128) * 128)
        padded = np.full(T, -1, np.int32)
        padded[: len(scores)] = scores
        self._scores_dev = jnp.asarray(padded)
        self._scores_host = scores
        self._pad = T
        self._build_prefix_cache(scores)

    def _build_prefix_cache(self, scores: np.ndarray) -> None:
        """Vectorized per-prefix top-k for prefix lengths 1..PRECOMP_LEN.

        Terms are sorted, so equal prefixes are contiguous; one lexsort per
        length orders each group by (score desc, term asc) and the first
        max_top of each group become its cached candidates.
        """
        self._pref_starts = {}
        self._pref_cands = {}
        n = len(self.terms)
        if n == 0:
            return
        K = self.max_top
        idx = np.arange(n, dtype=np.int64)
        for Lp in range(1, self.PRECOMP_LEN + 1):
            pref = np.asarray([t[:Lp] for t in self.terms], dtype=object)
            new_group = np.ones(n, bool)
            new_group[1:] = pref[1:] != pref[:-1]
            gid = np.cumsum(new_group) - 1  # [n] group id per term
            starts = idx[new_group]  # group -> first term index
            # order within group by (score desc, index asc)
            order = np.lexsort((idx, -scores, gid))
            # rank of each ordered element within its group
            g_of = gid[order]
            gstart_pos = np.searchsorted(g_of, np.arange(g_of[-1] + 1))
            rank = np.arange(n) - gstart_pos[g_of]
            keep = rank < K
            G = int(g_of[-1]) + 1
            cands = np.full((G, K), -1, np.int64)
            cands[g_of[keep], rank[keep]] = order[keep]
            self._pref_starts[Lp] = starts
            self._pref_cands[Lp] = cands

    def empty(self) -> bool:
        return not self.terms

    # ---------------- lookup ----------------

    def prefix_range(self, prefix: str) -> tuple[int, int]:
        lo = bisect.bisect_left(self.terms, prefix)
        hi = bisect.bisect_left(self.terms, prefix + "\U0010ffff")
        return lo, hi

    def _cached_topk(self, prefix: str, lo: int, L: int) -> Optional[List[int]]:
        """Precomputed (score desc, term asc) candidates for a short prefix."""
        starts = self._pref_starts.get(len(prefix))
        if starts is None:
            return None
        g = int(np.searchsorted(starts, lo))
        if g >= starts.shape[0] or starts[g] != lo:
            return None  # cache built from a different table; fall through
        return [int(c) for c in self._pref_cands[len(prefix)][g, :L] if c >= 0]

    def _host_range_topk(self, lo: int, hi: int, L: int) -> List[int]:
        """Top-L term indices of scores[lo:hi] by (score desc, term asc)."""
        rng = self._scores_host[lo:hi]
        order = np.argsort(-rng, kind="stable")[:L]  # stable = index asc ties
        return [lo + int(i) for i in order]

    def suggest_batch(
        self, inputs: Sequence[str], limit: int
    ) -> List[List[str]]:
        """Batched suggestions for concurrent requests.

        Short prefixes resolve from the per-prefix cache without touching
        the device; longer ones go through ONE windowed device launch (full
        table only when a range exceeds the largest window bucket).
        """
        from ..ops.prefix import prefix_range_topk, prefix_window_topk

        L = max(1, min(int(limit), self.max_top if self.terms else 10))
        out: List[Optional[List[str]]] = [None] * len(inputs)
        bases: List[str] = []
        los: List[int] = []
        his: List[int] = []
        rows: List[int] = []
        for i, user_input in enumerate(inputs):
            if self.empty():
                out[i] = []
                continue
            base, last = split_last_token(user_input)
            prefix = normalize_token(last)
            if not prefix:
                out[i] = []
                continue
            lo, hi = self.prefix_range(prefix)
            if lo >= hi:
                out[i] = []
                continue
            if len(prefix) <= self.PRECOMP_LEN:
                cand = self._cached_topk(prefix, lo, L)
                if cand is not None:
                    out[i] = [base + self.terms[c] for c in cand]
                    continue
            if hi - lo <= self.NARROW_RANGE:
                # Long prefixes cover narrow sorted-table ranges; a host
                # partial sort over the range is microseconds and skips
                # the device launch entirely.
                # With PRECOMP_LEN=5 covering the wide ranges, virtually
                # every suggest is now host-answered; the windowed device
                # kernel remains for wide uncached ranges (cache disabled
                # or exotic workloads). Tie order matches the kernel and
                # the reference trie: score desc, then term asc.
                out[i] = [
                    base + self.terms[c]
                    for c in self._host_range_topk(lo, hi, L)
                ]
                continue
            bases.append(base)
            los.append(lo)
            his.append(hi)
            rows.append(i)

        if rows:
            lo_a = np.asarray(los, np.int32)
            hi_a = np.asarray(his, np.int32)
            width = int((hi_a - lo_a).max())
            W = next(
                (w for w in self.WINDOW_BUCKETS if width <= w), None
            )
            if W is not None:
                vals, idx = prefix_window_topk(
                    self._scores_dev, lo_a, hi_a, L=L, W=W
                )
            else:  # a range wider than every bucket: full-table fallback
                vals, idx = prefix_range_topk(self._scores_dev, lo_a, hi_a, L=L)
            vals = np.asarray(vals)
            idx = np.asarray(idx)
            for j, i in enumerate(rows):
                sugg = []
                for l in range(L):
                    if vals[j, l] < 0:
                        break
                    sugg.append(bases[j] + self.terms[int(idx[j, l])])
                out[i] = sugg
        return [x if x is not None else [] for x in out]

    def suggest_query(self, user_input: str, limit: int) -> List[str]:
        return self.suggest_batch([user_input], limit)[0]
