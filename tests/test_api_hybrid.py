"""Server-level hybrid search (?hybrid=1) with embeddings loaded."""

import json
import threading

import numpy as np
import pytest

from nextsearch.api.ai import AzureOpenAIConfig
from nextsearch.api.feedback import FeedbackManager
from nextsearch.api.server import ServerContext, make_server
from nextsearch.api.stats import StatsTracker
from nextsearch.engine import Engine
from nextsearch.index.builder import build_segment_arrays
from nextsearch.index.segmentio import save_manifest, write_segment


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("apihy")
    d = tmp / "index"
    (d / "segments").mkdir(parents=True)
    docs = [
        {"cord_uid": "h1", "text": "covid vaccine trial"},
        {"cord_uid": "h2", "text": "covid corona outbreak"},
        {"cord_uid": "h3", "text": "banana bread recipe"},
    ]
    write_segment(build_segment_arrays(docs), d / "segments" / "seg_000001")
    save_manifest(d / "manifest.bin", ["seg_000001"])
    (d / "metadata.csv").write_text("cord_uid,title\nh1,One\nh2,Two\nh3,Three\n")
    rng = np.random.default_rng(2)
    terms = ["covid", "vaccine", "trial", "corona", "outbreak", "banana",
             "bread", "recipe"]
    lines = [t + " " + " ".join(f"{x:.5f}" for x in rng.normal(size=12))
             for t in terms]
    (d / "embeddings.vec").write_text("\n".join(lines) + "\n")

    engine = Engine(d, cache_dir=tmp)
    assert engine.reload() and engine.sem.enabled
    ctx = ServerContext(
        engine, StatsTracker(tmp / "stats.json"),
        FeedbackManager(tmp / "feedback.json"), AzureOpenAIConfig(),
    )
    srv = make_server(ctx, host="127.0.0.1", port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv, ctx
    srv.shutdown()
    ctx.batcher.shutdown()


def _get(server, path):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", server[0].server_port, timeout=60)
    conn.request("GET", path)
    r = conn.getresponse()
    body = json.loads(r.read())
    conn.close()
    return r.status, body


def test_hybrid_param_served(server):
    status, j = _get(server, "/api/search?q=covid&k=3&hybrid=1")
    assert status == 200
    assert j["hybrid"] is True
    assert j["cached"] is False and j["search_time_ms"] >= 0
    assert all("hybrid_score" in r for r in j["results"])
    # cached second call keeps the hybrid shape
    status2, j2 = _get(server, "/api/search?q=covid&k=3&hybrid=1")
    assert j2["cached"] is True and j2["hybrid"] is True


def test_hybrid_and_plain_caches_are_separate(server):
    _get(server, "/api/search?q=vaccine&k=3")
    status, j = _get(server, "/api/search?q=vaccine&k=3&hybrid=1")
    assert j["cached"] is False and j.get("hybrid") is True
    status, j2 = _get(server, "/api/search?q=vaccine&k=3")
    assert j2["cached"] is True and "hybrid" not in j2
