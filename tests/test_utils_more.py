"""Coverage for env loader, CRLF metadata rows, CORD JSON edges."""

from nextsearch.index.metadata import MetadataStore
from nextsearch.utils.cordjson import extract_text_from_cord_json
from nextsearch.utils.csvutil import csv_row, first_author_et_al
from nextsearch.utils.envloader import load_env_file


def test_env_loader_semantics(tmp_path):
    p = tmp_path / ".env"
    p.write_text(
        "# comment\n"
        "\n"
        "KEY1=value1\n"
        "KEY2 = spaced \n"
        'KEY3="quoted value"\n'
        "KEY4='single'\n"
        "NOEQUALS\n"
        "KEY5=with=equals\n"
    )
    env = load_env_file(p)
    assert env == {
        "KEY1": "value1",
        "KEY2": "spaced",
        "KEY3": "quoted value",
        "KEY4": "single",
        "KEY5": "with=equals",
    }
    assert load_env_file(tmp_path / "missing.env") == {}


def test_metadata_crlf_rows(tmp_path):
    # getline keeps '\r' inside fields; offsets must count them
    p = tmp_path / "metadata.csv"
    p.write_bytes(
        b"cord_uid,title,authors,publish_time,url,abstract\r\n"
        b"crlf1,Title One,Smith J,2020-01-01,https://x/1,Abs\r\n"
        b"crlf2,Title Two,,2020-01-02,,\r\n"
    )
    store = MetadataStore(p)
    assert "crlf1" in store and "crlf2" in store
    m = store.fetch("crlf1")
    assert m.title == "Title One"
    assert m.publish_time == "2020-01-01"
    m2 = store.fetch("crlf2")
    assert m2.title == "Title Two" and m2.author == ""


def test_csv_row_quote_semantics():
    # quote-toggling parser: quotes consumed, commas inside quotes literal
    assert csv_row('a,"b,c",d') == ["a", "b,c", "d"]
    assert csv_row('""') == [""]
    # the reference's toggle parser consumes ALL quotes (no "" escapes):
    # src/api_metadata.cpp:22-25 — we reproduce that exactly
    assert csv_row('x,"he said ""hi""",y') == ["x", "he said hi", "y"]
    assert csv_row("") == [""]


def test_first_author_variants():
    assert first_author_et_al("Smith, John; Doe, Jane") == "Smith et al."
    assert first_author_et_al("John Smith") == "Smith et al."
    assert first_author_et_al("(Zhang San) Chinese Name") == "San et al."
    assert first_author_et_al("") == ""
    assert first_author_et_al("  ,  ") == ""


def test_cordjson_edges():
    assert extract_text_from_cord_json({}) == ""
    assert extract_text_from_cord_json({"title": "T"}) == "T\n"
    j = {"title": "T", "abstract": [{"text": "A"}, {"notext": 1}],
         "body_text": [{"text": "B"}], "other": "ignored"}
    assert extract_text_from_cord_json(j) == "T\nA\nB\n"
    # non-dict sections and non-string text are skipped
    j2 = {"abstract": [None, {"text": 5}, {"text": "ok"}]}
    assert extract_text_from_cord_json(j2) == "ok\n"
