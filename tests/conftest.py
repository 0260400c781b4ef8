"""Test configuration: an 8-device virtual CPU mesh, or the GPU on request.

Multi-device sharding is tested without real hardware via XLA's host-platform
device-count override (SURVEY.md §4). `pytest -m gpu` runs the tests marked
`gpu` on the card instead; they skip (from the `gpu_device` fixture) where
JAX finds no GPU.
"""

import os

import jax
import numpy as np
import pytest


def pytest_configure(config):
    # Only the command line decides the platform (never a probe of the
    # card), so every xdist worker collects the same tests. Runs before
    # any test module is imported, hence before any JAX backend starts.
    if config.getoption("markexpr", "") != "gpu":
        os.environ["JAX_PLATFORMS"] = "cpu"
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", 8)


@pytest.fixture(scope="session")
def gpu_device():
    """The first GPU JAX sees; skips the test where there is none."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {devs[0].platform}")
    return devs[0]


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def make_synthetic_docs(n_docs: int, vocab: int, seed: int = 0, avg_len: int = 60):
    """Zipf-ish synthetic corpus with CORD-style doc dicts."""
    r = np.random.default_rng(seed)
    words = [f"w{i:04d}" for i in range(vocab)]
    probs = 1.0 / np.arange(1, vocab + 1) ** 1.1
    probs /= probs.sum()
    docs = []
    for i in range(n_docs):
        length = max(1, int(r.poisson(avg_len)))
        toks = r.choice(vocab, size=length, p=probs)
        docs.append(
            {
                "cord_uid": f"uid{i:05d}",
                "title": f"title {i}",
                "relpath": f"doc/{i}.json",
                "tokens": [words[t] for t in toks],
            }
        )
    return docs


@pytest.fixture(scope="session")
def synthetic_docs():
    return make_synthetic_docs(200, 300, seed=1)
