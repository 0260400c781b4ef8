"""The program carries no kernel, flag or backend branch for the accelerator
it was first written for, and the compile cache lives where
JAX_COMPILATION_CACHE_DIR says, else at a fixed path inside the checkout."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

# Patterns are assembled so that this file does not match itself.
_T = "tp" + "u"
FORBIDDEN = {
    "pallas_backend_import": re.compile(
        r"pallas[.\s]+(import\s+)?" + _T + r"\b"),
    "pallas_backend_alias": re.compile("pl" + _T),
    "backend_branch": re.compile(r"""==\s*["']""" + _T + r"""["']|["']"""
                                 + _T + r"""["']\s*=="""),
    "pallas_flag": re.compile("NEXTSEARCH_" + "PALLAS"),
    "test_flag": re.compile("NEXTSEARCH_TEST_" + _T.upper()),
}


def _sources():
    for p in sorted(REPO.rglob("*.py")):
        rel = p.relative_to(REPO)
        if rel.parts[0].startswith(".") or p == Path(__file__).resolve():
            continue
        yield rel, p.read_text(encoding="utf-8")


@pytest.mark.parametrize("name", sorted(FORBIDDEN))
def test_no_first_accelerator_code(name):
    pat = FORBIDDEN[name]
    hits = [
        f"{rel}:{i}"
        for rel, text in _sources()
        for i, line in enumerate(text.splitlines(), 1)
        if pat.search(line)
    ]
    assert not hits, hits


def _run(code, env):
    return subprocess.run(
        [sys.executable, "-c", code], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=300,
    )


_PROBE = """
import json, sys
from pathlib import Path
import nextsearch.utils.compilecache as cc
cc._DEFAULT = Path(sys.argv[-1])  # a default that must stay untouched
cc.enable_compilation_cache()
import jax, jax.numpy as jnp
jax.jit(lambda x: jnp.sin(x) * 3.0 + x)(jnp.arange(4096.0)).block_until_ready()
print(json.dumps({"dir": jax.config.jax_compilation_cache_dir}))
"""


def test_compile_cache_honors_env(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "env_cache"))
    default = tmp_path / "default_cache"
    r = subprocess.run(
        [sys.executable, "-c", _PROBE.replace("sys.argv[-1]",
                                              repr(str(default)))],
        cwd=str(REPO), env=env, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert str(tmp_path / "env_cache") in r.stdout
    assert (tmp_path / "env_cache").is_dir()
    assert not default.exists()  # no other cache directory is created


def test_compile_cache_default_is_fixed_inside_checkout(monkeypatch):
    from nextsearch.utils.compilecache import cache_dir

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert cache_dir() == REPO / ".jax_cache"
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/where")
    assert cache_dir() == Path("/some/where")
    assert cache_dir("explicit") == Path("explicit")
