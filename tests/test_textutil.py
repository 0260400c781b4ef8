"""Tokenizer/stoplist parity tests (reference: include/textutil.hpp)."""

from nextsearch.utils.textutil import (
    STOPWORDS,
    filter_terms,
    is_stopword,
    normalize_token,
    tokenize,
)


def test_tokenize_basic():
    assert tokenize("Hello, World! 123") == ["hello", "world", "123"]
    assert tokenize("COVID-19 mRNA-vaccine") == ["covid", "19", "mrna", "vaccine"]
    assert tokenize("") == []
    assert tokenize("...---...") == []


def test_tokenize_mixed_runs():
    # digits and letters form one run, exactly like C isalnum
    assert tokenize("abc123def") == ["abc123def"]
    assert tokenize("a_b") == ["a", "b"]  # underscore is a separator


def test_tokenize_utf8_bytes_are_separators():
    # The reference iterates raw bytes; multi-byte UTF-8 splits tokens.
    assert tokenize("naïve") == ["na", "ve"]
    assert tokenize("αβγ test") == ["test"]


def test_stopword_set_is_reference_24():
    expected = {
        "the", "a", "an", "and", "or", "of", "to", "in", "for", "on", "with",
        "by", "as", "is", "are", "was", "were", "be", "been", "it", "this",
        "that", "from", "at",
    }
    assert set(STOPWORDS) == expected
    assert len(STOPWORDS) == 24
    assert is_stopword("the") and not is_stopword("covid")


def test_filter_terms_len_and_stopwords():
    toks = tokenize("A x to the covid of immunity and t7")
    assert filter_terms(toks) == ["covid", "immunity", "t7"]


def test_normalize_token():
    assert normalize_token("Hello-World!") == "helloworld"
    assert normalize_token("ABC123") == "abc123"
    assert normalize_token("...") == ""
    assert normalize_token("naïve") == "nave"
