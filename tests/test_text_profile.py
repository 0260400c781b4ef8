"""Tokenized-text df-profile regression (VERDICT r4 weak-1).

The tools-built corpus showed a failure class the synthetic Zipf
headline never hits: near-uniform heavy tails (many df~N terms from
realistic tokenized text) trip the fast-heavy guard, and a config drift
that re-trips every batch silently costs 30-45% QPS. This test builds a
REAL tokenized-text segment (the product tokenizer over generated text,
same pipeline as tools/forwardindex), runs df-weighted serving-shaped
batches through the production sparse path, and asserts:
  - exact oracle parity at serving shapes (pinned envelopes),
  - the guard trip rate stays ~0 after the rescue memo warms
    (first-pass trips are rescued exactly; recurrences must memo).
"""

import numpy as np
import pytest

from nextsearch.config import DeviceConfig, EngineConfig
from nextsearch.index.builder import build_segment_arrays
from nextsearch.index.oracle import oracle_search
from nextsearch.index.segment import DeviceIndex


@pytest.fixture(scope="module")
def text_segment():
    # Zipf word stream with a FLAT head (several df~N words) — the
    # tokenized-text shape that produced the tools corpus's persistent
    # tripper ("covid corona", both df~1M).
    rng = np.random.default_rng(205)
    vocab = 600
    words = [f"word{i:04d}" for i in range(vocab)]
    probs = 1.0 / np.arange(1, vocab + 1) ** 1.07
    probs[:4] = probs[0]  # flat df~N head
    probs /= probs.sum()
    docs = []
    for i in range(4000):
        n = int(rng.integers(8, 30))
        toks = rng.choice(vocab, size=n, p=probs)
        # the 4 head words appear in nearly every doc (df ~ N)
        text = " ".join(words[t] for t in toks) + " word0000 word0001"
        docs.append({"cord_uid": f"u{i}", "text": text})
    return build_segment_arrays(docs)


def test_text_profile_parity_and_trip_rate(text_segment):
    seg = text_segment
    cfg = EngineConfig(
        device=DeviceConfig(
            mode="sparse", posting_block=64,
            chunk_buckets=(256, 1024, 4096),
            dense_df_ratio=1 / 1024, fast_heavy=True,
        )
    )
    di = DeviceIndex([seg], config=cfg)
    assert di.n_dense > 0

    # df-weighted query stream (the serving model): heavy head words
    # recur constantly, including the 2-term df~N shape
    dfs = seg.term_df.astype(np.float64)
    cum = np.cumsum(dfs / dfs.sum())
    cum[-1] = 1.0
    rng = np.random.default_rng(7)

    def mk_batch(n):
        out = []
        for _ in range(n):
            w = int(rng.integers(1, 4))
            picks = np.searchsorted(cum, rng.random(w), "right")
            out.append(
                [(seg.terms[int(t)], 1.0) for t in dict.fromkeys(picks)]
            )
        return out

    batches = [mk_batch(64) for _ in range(4)]
    di.pin_shapes(batches, scope_q=True)

    # pass 1: any trips are rescued exactly (and memoized)
    osegs = [seg.to_oracle_segment()]
    for b in batches:
        results = di.search_batch(b, k=10)
        for terms, res in zip(b, results):
            hits, found = oracle_search(osegs, terms, k=10)
            assert res.found == found, terms
            for (o_s, _sg, o_d), d_s, d_slot in zip(
                hits, res.scores, res.doc_slots
            ):
                assert di.locate(int(d_slot))[1] == o_d, terms
                assert np.float32(d_s) == np.float32(o_s), terms
    first_pass_trips = di.rescue_trips

    # pass 2: the same stream must not re-trip (memo) — a re-tripping
    # config is the silent 30-45% QPS regression class
    for b in batches:
        di.search_batch(b, k=10)
    assert di.rescue_trips == first_pass_trips, (
        "guard re-tripped on a repeated stream: rescue memo regressed"
    )
