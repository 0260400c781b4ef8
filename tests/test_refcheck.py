"""Cross-validate the NumPy oracle against compiled C++ float semantics.

index/oracle.py is the parity anchor every device kernel is tested against;
this test closes the loop by asserting the oracle is bit-identical to an
independently-written C++ program (native/refcheck.cpp) that follows the
reference engine's scoring loop (/root/reference/src/api_engine.cpp:441-496)
and reads reference-format segment files produced by segmentio.write_segment
— validating both the float semantics AND the on-disk byte compatibility.
"""

import shutil
import struct
import subprocess

import numpy as np
import pytest

from nextsearch.index.builder import build_segment_arrays
from nextsearch.index.oracle import oracle_search
from nextsearch.index.segmentio import write_segment

from conftest import make_synthetic_docs

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None, reason="needs a C++ compiler"
)


@pytest.fixture(scope="module")
def refcheck_bin(tmp_path_factory):
    from pathlib import Path

    src = Path(__file__).resolve().parent.parent / (
        "nextsearch/native/refcheck.cpp"
    )
    out = tmp_path_factory.mktemp("refcheck") / "refcheck"
    subprocess.run(
        ["g++", "-O2", "-std=c++17", "-o", str(out), str(src)],
        check=True,
        capture_output=True,
    )
    return out


@pytest.fixture(scope="module", params=["legacy", "barrels"])
def corpus(tmp_path_factory, request):
    tmp = tmp_path_factory.mktemp(f"refcorpus_{request.param}")
    segs = [
        build_segment_arrays(make_synthetic_docs(80, 250, seed=50)),
        build_segment_arrays(make_synthetic_docs(120, 250, seed=51, avg_len=35)),
        build_segment_arrays(make_synthetic_docs(50, 250, seed=52, avg_len=90)),
    ]
    dirs = []
    for i, seg in enumerate(segs):
        d = tmp / f"seg_{i + 1:06d}"
        write_segment(seg, d, barrels=(request.param == "barrels"))
        dirs.append(d)
    return segs, dirs


def _queries(seed=9, n=40, vocab=250):
    r = np.random.default_rng(seed)
    words = [f"w{i:04d}" for i in range(vocab)]
    out = []
    for _ in range(n):
        nt = int(r.integers(1, 5))
        out.append(
            [
                (words[int(r.integers(0, vocab))], float(r.uniform(0.25, 1.5)))
                for _ in range(nt)
            ]
        )
    out.append([("nosuchterm", 1.0)])
    return out


def test_oracle_matches_compiled_reference_semantics(refcheck_bin, corpus):
    segs, dirs = corpus
    queries = _queries()
    k = 10

    lines = []
    for terms in queries:
        parts = [str(k)]
        for t, w in terms:
            # full precision so the C++ side parses the identical f32
            parts.append(np.format_float_positional(np.float32(w)))
            parts.append(t)
        lines.append(" ".join(parts))
    proc = subprocess.run(
        [str(refcheck_bin)] + [str(d) for d in dirs],
        input="\n".join(lines) + "\n",
        capture_output=True,
        text=True,
        check=True,
    )
    out_lines = proc.stdout.strip().split("\n")
    assert len(out_lines) == len(queries)

    oracle_segs = [s.to_oracle_segment() for s in segs]
    for terms, line in zip(queries, out_lines):
        fields = line.split()
        cpp_found = int(fields[0])
        cpp_hits = []
        for f in fields[1:]:
            hx, seg_i, doc = f.split(":")
            (score,) = struct.unpack("<f", struct.pack("<I", int(hx, 16)))
            cpp_hits.append((np.float32(score), int(seg_i), int(doc)))

        hits, found = oracle_search(oracle_segs, terms, k=k)
        assert cpp_found == found, terms
        assert len(cpp_hits) == len(hits), terms
        for (o_s, o_seg, o_doc), (c_s, c_seg, c_doc) in zip(hits, cpp_hits):
            assert (c_seg, c_doc) == (o_seg, o_doc), terms
            # bit-exact float parity between NumPy oracle and compiled C++
            assert np.float32(o_s).tobytes() == np.float32(c_s).tobytes(), (
                terms,
                o_s,
                c_s,
            )
