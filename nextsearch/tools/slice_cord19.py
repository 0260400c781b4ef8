"""slice_cord19 CLI: carve an n-doc random slice of a CORD-19 corpus.

Reference: scripts/slice_cord19.cpp:149-301 — samples rows of metadata.csv
with a seeded shuffle, copies the referenced paper JSONs, and writes a
sliced metadata.csv (fields quoted when they contain commas/quotes).

Usage: python -m nextsearch.tools.slice_cord19 \
    --in_root DIR --out_root DIR --n N [--seed S]
    [--prefer pmc|pdf|either] [--require_body]
"""

from __future__ import annotations

import argparse
import random
import shutil
import sys
from pathlib import Path

from ..utils.csvutil import csv_row
from .forwardindex import pick_first_path


def quote_csv_field(s: str) -> str:
    if any(c in s for c in ',"\n'):
        return '"' + s.replace('"', '""') + '"'
    return s


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="slice_cord19")
    p.add_argument("--in_root", required=True)
    p.add_argument("--out_root", required=True)
    p.add_argument("--n", type=int, required=True)
    p.add_argument("--seed", type=int, default=12345)
    p.add_argument("--prefer", choices=["pmc", "pdf", "either"], default="either")
    p.add_argument("--require_body", action="store_true")
    args = p.parse_args(argv)

    in_root = Path(args.in_root)
    out_root = Path(args.out_root)
    meta = in_root / "metadata.csv"
    if not meta.exists():
        print(f"metadata.csv not found: {meta}", file=sys.stderr)
        return 1

    with open(meta, "r", encoding="utf-8", errors="replace", newline="") as f:
        header = f.readline().rstrip("\n")
        cols = csv_row(header)
        try:
            i_pdf = cols.index("pdf_json_files")
            i_pmc = cols.index("pmc_json_files")
        except ValueError:
            print("metadata.csv missing pdf/pmc json columns", file=sys.stderr)
            return 1
        rows = [line.rstrip("\n") for line in f if line.strip()]

    rng = random.Random(args.seed)
    rng.shuffle(rows)

    picked = []
    for line in rows:
        if len(picked) >= args.n:
            break
        r = csv_row(line)
        if len(r) <= max(i_pdf, i_pmc):
            continue
        pmc_rel = pick_first_path(r[i_pmc])
        pdf_rel = pick_first_path(r[i_pdf])
        if args.prefer == "pmc":
            rel = pmc_rel
        elif args.prefer == "pdf":
            rel = pdf_rel
        else:
            rel = pmc_rel or pdf_rel
        if not rel:
            continue
        src = in_root / rel
        if not src.exists():
            continue
        if args.require_body:
            from ..utils.cordjson import extract_text_from_file

            if not extract_text_from_file(src).strip():
                continue
        picked.append((line, rel))

    out_root.mkdir(parents=True, exist_ok=True)
    with open(out_root / "metadata.csv", "w", encoding="utf-8", newline="") as f:
        f.write(header + "\n")
        for line, rel in picked:
            # re-write the row with proper quoting
            fields = csv_row(line)
            f.write(",".join(quote_csv_field(x) for x in fields) + "\n")
    for _line, rel in picked:
        dst = out_root / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(in_root / rel, dst)

    print(f"Sliced {len(picked)} docs into {out_root}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
