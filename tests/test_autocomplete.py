"""Autocomplete parity tests (reference: src/api_autocomplete.cpp)."""

import pytest

from nextsearch.models.autocomplete import AutocompleteIndex, split_last_token


@pytest.fixture(scope="module")
def ac():
    idx = AutocompleteIndex()
    idx.build(
        {
            "covid": 500,
            "coronavirus": 300,
            "corona": 300,  # tie with coronavirus -> term asc
            "cough": 100,
            "cov": 90,
            "vaccine": 400,
            "vaccination": 50,
            "x": 7,  # len < 2 -> excluded
            "zz9": 1,
        },
        10,
    )
    return idx


def test_split_last_token():
    assert split_last_token("hello wor") == ("hello ", "wor")
    assert split_last_token("covid ") == ("", "covid")  # trailing space dropped
    assert split_last_token("a b, c") == ("a b, ", "c")
    assert split_last_token("...") == ("", "")
    assert split_last_token("one-two") == ("one-", "two")


def test_prefix_ranking_score_desc_term_asc(ac):
    # cov* -> covid(500), corona?? no: corona doesn't start with cov
    assert ac.suggest_query("cov", 10) == ["covid", "cov"]
    # co* -> covid500, corona300, coronavirus300 (tie: term asc), cough100, cov90
    assert ac.suggest_query("co", 10) == [
        "covid", "corona", "coronavirus", "cough", "cov",
    ]


def test_limit_truncation(ac):
    assert ac.suggest_query("co", 2) == ["covid", "corona"]


def test_multiword_base_preserved(ac):
    assert ac.suggest_query("mRNA vac", 2) == ["mRNA vaccine", "mRNA vaccination"]
    # normalization lowercases the prefix but base keeps original case
    assert ac.suggest_query("The COV", 1) == ["The covid"]


def test_no_match_and_empty(ac):
    assert ac.suggest_query("qqq", 5) == []
    assert ac.suggest_query("   ", 5) == []
    assert ac.suggest_query("", 5) == []


def test_short_terms_excluded(ac):
    assert "x" not in ac.terms
    assert ac.suggest_query("x", 5) == []


def test_batched_matches_single(ac):
    inputs = ["co", "vac", "qqq", "mRNA vac", ""]
    batched = ac.suggest_batch(inputs, 5)
    singles = [ac.suggest_query(i, 5) for i in inputs]
    assert batched == singles


def test_empty_index():
    idx = AutocompleteIndex()
    idx.build({}, 10)
    assert idx.empty()
    assert idx.suggest_query("co", 5) == []


def test_prefix_cache_matches_bruteforce():
    """Cached (len<=4), windowed, and full-table paths all equal brute force."""
    import numpy as np

    from nextsearch.models.autocomplete import AutocompleteIndex

    r = np.random.default_rng(12)
    # vocabulary with dense shared prefixes at many lengths
    alphabet = "abcd"
    terms = set()
    while len(terms) < 3000:
        length = int(r.integers(2, 9))
        terms.add("".join(alphabet[int(c)] for c in r.integers(0, 4, length)))
    scores = {t: int(r.integers(1, 10_000)) for t in terms}

    ac = AutocompleteIndex()
    ac.build(scores, max_candidates_per_prefix=10)

    def brute(prefix, L):
        cand = [(t, s) for t, s in scores.items() if t.startswith(prefix)]
        cand.sort(key=lambda x: (-x[1], x[0]))
        return [t for t, _s in cand[:L]]

    prefixes = ["a", "ab", "abc", "abcd", "abcda", "dcba", "aaaa", "b", "bc"]
    for p in prefixes:
        for L in (1, 3, 10):
            got = ac.suggest_batch([p], L)[0]
            assert got == brute(p, L), (p, L)

    # batch mixing cached + windowed rows keeps row alignment
    batch = ["a", "abcda", "zz", "dc", "abcd"]
    got = ac.suggest_batch(batch, 5)
    assert got == [brute(p, 5) for p in batch]


def test_prefix_cache_wide_vocab_uses_cache(monkeypatch):
    """Short-prefix lookups never launch a device kernel."""
    from nextsearch.models.autocomplete import AutocompleteIndex

    ac = AutocompleteIndex()
    ac.build({f"term{i:05d}": i + 1 for i in range(5000)})

    import nextsearch.ops.prefix as prefix_ops

    def boom(*a, **k):
        raise AssertionError("device kernel must not run for short prefixes")

    monkeypatch.setattr(prefix_ops, "prefix_range_topk", boom)
    monkeypatch.setattr(prefix_ops, "prefix_window_topk", boom)
    res = ac.suggest_batch(["te", "term", "t"], 5)
    assert res[1][:1] == ["term04999"]  # highest score first


def test_host_narrow_range_matches_device_path():
    """Long-prefix suggests answer host-side (narrow sorted-table range,
    partial sort) with EXACTLY the device kernel's results and tie order
    (score desc, term asc)."""
    import numpy as np

    from nextsearch.models.autocomplete import AutocompleteIndex

    rng = np.random.default_rng(3)
    terms = {}
    for i in range(3000):
        t = f"prefix{i % 40:02d}word{i:04d}"
        terms[t] = int(rng.integers(1, 10_000))
    # forced score ties inside one prefix group exercise the tie order
    for i in range(10):
        terms[f"prefix00tie{i}"] = 777
    ac = AutocompleteIndex()
    ac.build(terms, 10)
    for q in ("prefix00", "prefix07wo", "prefix00tie", "prefix39word2"):
        host = ac.suggest_query(q, 10)
        # same lookup forced through the device/window path
        lo, hi = ac.prefix_range(q)
        if lo >= hi:
            assert host == []
            continue
        old = AutocompleteIndex.NARROW_RANGE
        AutocompleteIndex.NARROW_RANGE = 0  # force kernel path
        try:
            dev = ac.suggest_query(q, 10)
        finally:
            AutocompleteIndex.NARROW_RANGE = old
        assert host == dev, (q, host, dev)
