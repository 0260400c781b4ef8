"""chip_smoke.py off the card: it refuses to run, and its oracle comparison
catches any difference from the reference."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


def _run_smoke(cwd, script, env=None):
    return subprocess.run(
        [sys.executable, str(script)], cwd=str(cwd),
        env=dict(os.environ, JAX_PLATFORMS="cpu", **(env or {})),
        capture_output=True, text=True, timeout=300,
    )


def _has_ok_line(stdout):
    for line in stdout.splitlines():
        try:
            if json.loads(line).get("ok"):
                return True
        except ValueError:
            continue
    return False


def test_refuses_without_gpu():
    r = _run_smoke(REPO, REPO / "chip_smoke.py")
    assert r.returncode != 0
    assert not _has_ok_line(r.stdout)
    assert "no GPU" in r.stdout


def test_refuses_without_the_repository(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run_smoke(tmp_path, tmp_path / "chip_smoke.py",
                   env={"PYTHONPATH": ""})
    assert r.returncode != 0
    assert not _has_ok_line(r.stdout)


def _served(hits, found):
    return {"found": found, "results": [
        {"score": float(s), "segment": seg, "docId": d} for s, seg, d in hits
    ]}


_NAMES = ["seg_000001", "seg_000002"]
_ORACLE = ([(np.float32(7.25), 0, 4), (np.float32(3.0000002), 1, 9)], 12)


def test_compare_result_accepts_exact_match():
    res = _served([(7.25, "seg_000001", 4), (3.0000002, "seg_000002", 9)], 12)
    assert chip_smoke.compare_result(res, _ORACLE, _NAMES) is None


@pytest.mark.parametrize("perturb", ["score_ulp", "doc", "segment", "found",
                                     "missing_hit"])
def test_compare_result_catches_differences(perturb):
    hits = [[7.25, "seg_000001", 4], [3.0000002, "seg_000002", 9]]
    found = 12
    if perturb == "score_ulp":
        hits[1][0] = float(np.nextafter(np.float32(3.0000002), np.float32(9)))
    elif perturb == "doc":
        hits[0][2] = 5
    elif perturb == "segment":
        hits[0][1] = "seg_000002"
    elif perturb == "found":
        found = 13
    else:
        hits = hits[:1]
    res = _served([tuple(h) for h in hits], found)
    assert chip_smoke.compare_result(res, _ORACLE, _NAMES) is not None


def test_guard_trips_parsed_from_server_log():
    log = (
        "[sparse] fast-heavy guard tripped (3/512 queries); host-oracle "
        "rescue 12.0ms\n[search] batch n=512\n"
        "[sparse] fast-heavy guard tripped (40/512 queries); relaunching "
        "exact-precision kernel\n"
    )
    assert chip_smoke.guard_trips(log) == {
        "queries": 43, "batches": 2, "host_rescue": 3, "relaunch": 40,
    }
