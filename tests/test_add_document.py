"""Enabled add_document pipeline: zip upload -> segment build -> reload."""

import io
import json
import threading
import zipfile

import pytest

from nextsearch.api.ai import AzureOpenAIConfig
from nextsearch.api.feedback import FeedbackManager
from nextsearch.api.server import ServerContext, make_server
from nextsearch.api.stats import StatsTracker
from nextsearch.engine import Engine
from nextsearch.index.builder import build_segment_arrays
from nextsearch.index.segmentio import save_manifest, write_segment

from test_engine import DOCS_SEG1, METADATA_CSV


def _slice_zip() -> bytes:
    """A minimal CORD-19 slice zip with one paper."""
    doc = {
        "paper_id": "zzz1",
        "title": "quokka immunology",
        "abstract": [{"text": "quokka antibodies"}],
        "body_text": [{"text": "quokka immune response quokka"}],
    }
    meta = (
        "cord_uid,title,authors,publish_time,url,abstract,"
        "pdf_json_files,pmc_json_files\n"
        'zzz1,"Quokka Immunology",,2022-02-02,,,'
        ",document_parses/pmc_json/zzz1.xml.json\n"
    )
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        z.writestr("slice/metadata.csv", meta)
        z.writestr("slice/document_parses/pmc_json/zzz1.xml.json", json.dumps(doc))
    return buf.getvalue()


@pytest.fixture()
def server(tmp_path):
    d = tmp_path / "index"
    (d / "segments").mkdir(parents=True)
    write_segment(build_segment_arrays(DOCS_SEG1), d / "segments" / "seg_000001")
    save_manifest(d / "manifest.bin", ["seg_000001"])
    (d / "metadata.csv").write_text(METADATA_CSV)
    engine = Engine(d, cache_dir=tmp_path)
    assert engine.reload()
    ctx = ServerContext(
        engine, StatsTracker(tmp_path / "stats.json"),
        FeedbackManager(tmp_path / "feedback.json"),
        AzureOpenAIConfig(), enable_add_document=True,
    )
    srv = make_server(ctx, host="127.0.0.1", port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv, ctx
    srv.shutdown()
    ctx.batcher.shutdown()


def _post(server, path, body, ctype):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", server[0].server_port, timeout=60)
    conn.request("POST", path, body=body, headers={"Content-Type": ctype})
    r = conn.getresponse()
    data = json.loads(r.read())
    conn.close()
    return r.status, data


def test_add_document_raw_zip(server):
    status, j = _post(server, "/api/add_document", _slice_zip(), "application/zip")
    assert status == 200, j
    assert j["success"] is True and j["segment"] == "seg_000002"
    assert j["docs"] == 1 and j["reloaded"] is True

    # the new doc is searchable immediately
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", server[0].server_port, timeout=60)
    conn.request("GET", "/api/search?q=quokka&k=5")
    r = json.loads(conn.getresponse().read())
    conn.close()
    assert r["found"] == 1
    assert r["results"][0]["cord_uid"] == "zzz1"
    assert r["segments"] == 2


def test_add_document_multipart(server):
    zip_bytes = _slice_zip()
    boundary = "XBOUNDARYX"
    body = (
        f"--{boundary}\r\n"
        'Content-Disposition: form-data; name="file"; filename="slice.zip"\r\n'
        "Content-Type: application/zip\r\n\r\n"
    ).encode() + zip_bytes + f"\r\n--{boundary}--\r\n".encode()
    status, j = _post(
        server, "/api/add_document", body,
        f"multipart/form-data; boundary={boundary}",
    )
    assert status == 200, j
    assert j["success"] is True


def test_add_document_bad_zip(server):
    status, j = _post(server, "/api/add_document", b"not a zip", "application/zip")
    assert status == 400
    assert j["error"] == "upload is not a valid zip archive"


def test_add_document_no_metadata(server):
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        z.writestr("readme.txt", "hi")
    status, j = _post(server, "/api/add_document", buf.getvalue(), "application/zip")
    assert status == 400
    assert j["error"] == "zip does not contain metadata.csv"


def test_add_document_empty_body(server):
    status, j = _post(server, "/api/add_document", b"", "application/zip")
    assert status == 400
