"""adddocument CLI: one CORD JSON -> a new single-doc segment + manifest.

Reference: src/AddDocument.cpp:38-173 — builds a one-document segment
(barrelized here; the reference writes the legacy format) and appends it to
manifest.bin. Segment ids continue from the highest existing id (the
reference's `segs.size() + 2` quirk over-skips ids; we use max+1).

Usage: python -m nextsearch.tools.adddocument \
    <INDEX_DIR> <CORD_ROOT> <JSON_REL_PATH> <CORD_UID> <TITLE>
"""

from __future__ import annotations

import re
import sys
from pathlib import Path

from ..index.builder import build_segment_arrays
from ..index.segmentio import (
    discover_segments,
    save_manifest,
    seg_name,
    write_segment,
)
from ..utils.cordjson import extract_text_from_file


def next_seg_id(seg_names) -> int:
    best = 0
    for name in seg_names:
        m = re.fullmatch(r"seg_(\d+)", name)
        if m:
            best = max(best, int(m.group(1)))
    return best + 1


def run(index_dir: str, cord_root: str, json_rel: str, cord_uid: str, title: str) -> int:
    index_dir = Path(index_dir)
    json_path = Path(cord_root) / json_rel
    text = extract_text_from_file(json_path)
    if not text:
        print(f"Failed to read or parse: {json_path}", file=sys.stderr)
        return 1
    seg = build_segment_arrays(
        [{"cord_uid": cord_uid, "title": title, "relpath": json_rel, "text": text}],
        with_scores=False,
    )
    if seg.N == 0:
        print("Document produced no indexable tokens.", file=sys.stderr)
        return 1

    seg_names = discover_segments(index_dir)
    new_name = seg_name(next_seg_id(seg_names))
    segdir = index_dir / "segments" / new_name
    write_segment(seg, segdir, barrels=True)
    save_manifest(index_dir / "manifest.bin", list(seg_names) + [new_name])
    print(f"Wrote single-doc segment {new_name} and updated manifest.", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 5:
        print(
            "Usage: python -m nextsearch.tools.adddocument "
            "<INDEX_DIR> <CORD_ROOT> <JSON_REL_PATH> <CORD_UID> <TITLE>",
            file=sys.stderr,
        )
        return 1
    return run(*argv[:5])


if __name__ == "__main__":
    sys.exit(main())
