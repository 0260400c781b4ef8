"""Tokenizer and stoplist with byte-exact parity to the reference engine.

Parity contract (reference: include/textutil.hpp:13-37):
  - tokenize keeps runs of ASCII [0-9A-Za-z] bytes, lowercased. The reference
    iterates raw bytes with C-locale isalnum, so multi-byte UTF-8 sequences are
    treated as separators; we therefore tokenize over the UTF-8 byte string,
    never over Python unicode codepoints.
  - the stoplist is the reference's exact 24-word set.
  - query/index both drop tokens shorter than 2 chars and stopwords
    (reference: src/api_engine.cpp:393-396, src/ForwardIndex.cpp:146-151).

A vectorized batch variant and an optional C++ fast path live in
nextsearch.native; this module is the semantic ground truth.
"""

from __future__ import annotations

import re
from typing import Iterable, List, Union

_TOKEN_RE = re.compile(rb"[0-9A-Za-z]+")

# Reference stoplist: include/textutil.hpp:32-35 (24 words).
STOPWORDS = frozenset(
    {
        "the", "a", "an", "and", "or", "of", "to", "in", "for", "on", "with",
        "by", "as", "is", "are", "was", "were", "be", "been", "it", "this",
        "that", "from", "at",
    }
)


def tokenize(text: Union[str, bytes]) -> List[str]:
    """Split text into lowercase ASCII-alphanumeric runs.

    Mirrors reference tokenize (include/textutil.hpp:13-28) byte for byte.
    """
    if isinstance(text, str):
        data = text.encode("utf-8", errors="surrogatepass")
    else:
        data = text
    return [m.group(0).lower().decode("ascii") for m in _TOKEN_RE.finditer(data)]


def is_stopword(token: str) -> bool:
    """True when the token is in the reference's 24-word stoplist."""
    return token in STOPWORDS


def filter_terms(tokens: Iterable[str]) -> List[str]:
    """Drop tokens with len<2 and stopwords — the shared query/index filter."""
    return [t for t in tokens if len(t) >= 2 and t not in STOPWORDS]


def tokenize_filtered(text: Union[str, bytes]) -> List[str]:
    """tokenize + filter_terms in one call (index/build hot path)."""
    return filter_terms(tokenize(text))


def normalize_token(s: str) -> str:
    """Keep only lowercase ASCII alnum chars — autocomplete normalization.

    Mirrors AutocompleteIndex::normalize_token (src/api_autocomplete.cpp:23-30).
    """
    data = s.encode("utf-8", errors="surrogatepass")
    return bytes(
        b + 32 if 65 <= b <= 90 else b
        for b in data
        if (48 <= b <= 57) or (65 <= b <= 90) or (97 <= b <= 122)
    ).decode("ascii")
