"""forwardindex CLI: CORD-19 root -> forward-stage segment files.

Stage 1 of the offline index build (reference: src/ForwardIndex.cpp:54-233):
read metadata.csv, pick the PMC JSON (falling back to PDF), extract
title+abstract+body text, tokenize with the stoplist/len>=2 filter, and write
docs.bin / stats.bin / forward.bin / terms.bin.

Usage: python -m nextsearch.tools.forwardindex <CORD_ROOT> <SEGMENT_DIR>
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Iterator, Optional

from ..index.builder import build_segment_arrays
from ..index.segmentio import write_segment
from ..utils.cordjson import extract_text_from_file
from ..utils.csvutil import csv_row


def pick_first_path(s: str) -> str:
    """First path of a ';'-separated list, trimmed (ForwardIndex.cpp:43-51)."""
    pos = s.find(";")
    first = s if pos < 0 else s[:pos]
    first = first.rstrip(" \r")
    return first.lstrip(" ")


def iter_cord_docs(root: Path, log_every: int = 1000) -> Iterator[dict]:
    """Yield build_segment_arrays-ready doc dicts from a CORD-19 root."""
    meta = root / "metadata.csv"
    if not meta.exists():
        raise FileNotFoundError(f"metadata.csv not found: {meta}")
    with open(meta, "r", encoding="utf-8", errors="replace", newline="") as f:
        header = f.readline().rstrip("\n")
        cols = csv_row(header)

        def idx_of(name: str) -> int:
            try:
                return cols.index(name)
            except ValueError:
                return -1

        i_uid = idx_of("cord_uid")
        i_title = idx_of("title")
        i_pdf = idx_of("pdf_json_files")
        i_pmc = idx_of("pmc_json_files")
        if min(i_uid, i_title, i_pdf, i_pmc) < 0:
            raise ValueError("metadata.csv missing required columns.")

        n = 0
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            r = csv_row(line)
            if len(r) <= max(i_uid, i_title, i_pdf, i_pmc):
                continue
            pmc_rel = pick_first_path(r[i_pmc])
            pdf_rel = pick_first_path(r[i_pdf])
            rel = pmc_rel or pdf_rel
            if not rel:
                continue
            json_path = root / rel
            if not json_path.exists():
                continue
            text = extract_text_from_file(json_path)
            if not text:
                continue
            n += 1
            if log_every and n % log_every == 0:
                print(f"Docs: {n}", file=sys.stderr)
            yield {
                "cord_uid": r[i_uid],
                "title": r[i_title],
                "relpath": rel,
                "text": text,
            }


def run(cord_root: str, segment_dir: str, stages: str = "forward") -> int:
    root = Path(cord_root)
    seg_dir = Path(segment_dir)
    seg_dir.mkdir(parents=True, exist_ok=True)
    seg = build_segment_arrays(iter_cord_docs(root), with_scores=False)
    write_segment(seg, seg_dir, stages=stages)
    print(
        f"Wrote forward+terms+docs+stats to segment: {seg_dir}", file=sys.stderr
    )
    print(
        f"Now run: python -m nextsearch.tools.lexicon {seg_dir}",
        file=sys.stderr,
    )
    return 0


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2:
        print(
            "Usage: python -m nextsearch.tools.forwardindex "
            "<CORD_ROOT> <SEGMENT_DIR>",
            file=sys.stderr,
        )
        return 1
    return run(argv[0], argv[1])


if __name__ == "__main__":
    sys.exit(main())
