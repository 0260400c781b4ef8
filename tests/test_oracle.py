

def test_oracle_search_vec_bitexact():
    """oracle_search_vec must match the scalar oracle bit-for-bit,
    including tie order, found counts and multi-segment merges."""
    import numpy as np

    from nextsearch.index.builder import build_segment_arrays
    from nextsearch.index.oracle import oracle_search, oracle_search_vec

    r = np.random.default_rng(23)
    words = [f"w{i:03d}" for i in range(60)]
    docs = []
    for i in range(300):
        toks = [words[t] for t in r.integers(0, 60, int(r.integers(4, 30)))]
        docs.append({"cord_uid": f"d{i}", "tokens": toks})
    # identical docs -> exact score ties across docs and segments
    docs[50]["tokens"] = docs[51]["tokens"] = docs[200]["tokens"]
    segs = [
        build_segment_arrays(docs[:150]).to_oracle_segment(),
        build_segment_arrays(docs[150:]).to_oracle_segment(),
    ]
    for _ in range(40):
        nt = int(r.integers(1, 6))
        terms = [
            (words[int(r.integers(0, 60))], float(r.uniform(0.2, 1.5)))
            for _ in range(nt)
        ]
        if r.random() < 0.3 and nt > 1:
            terms[1] = terms[0]  # duplicate term in query
        k = int(r.integers(1, 15))
        h1, f1 = oracle_search(segs, terms, k)
        h2, f2 = oracle_search_vec(segs, terms, k)
        assert f1 == f2, terms
        assert len(h1) == len(h2), terms
        for (s1, g1, d1), (s2, g2, d2) in zip(h1, h2):
            assert np.float32(s1) == np.float32(s2), terms
            assert (g1, d1) == (g2, d2), terms
