"""The Penn Treebank word tokenizer: a copy of NLTK's
``TreebankWordTokenizer.tokenize`` (``nltk/tokenize/treebank.py``, with the
contraction lists of ``nltk/tokenize/destructive.py``'s
``MacIntyreContractions``), so the STS-B pipeline tokenizes without NLTK
installed.

Copyright (C) 2001-2026 NLTK Project. Authors: Edward Loper, Michael
Heilman (re-port from http://www.cis.upenn.edu/~treebank/tokenizer.sed),
Tom Aarsen. Licensed under the Apache License, Version 2.0
(http://www.apache.org/licenses/LICENSE-2.0); distributed on an "AS IS"
basis, without warranties or conditions of any kind. Changes from the
original: a module-level function instead of a class; the
``convert_parentheses`` and ``return_str`` options, and ``span_tokenize``,
are left out.

The JAX package tokenizes with ``nltk.word_tokenize`` where NLTK's punkt
data is installed and with ``TreebankWordTokenizer().tokenize`` where it is
not; this port always runs the latter (``word_tokenize`` also splits
sentences first, so the two differ on text with a period inside it).
"""

from __future__ import annotations

import re

# starting quotes
STARTING_QUOTES = [
    (re.compile(r"^\""), r"``"),
    (re.compile(r"(``)"), r" \1 "),
    (re.compile(r"([ \(\[{<])(\"|\'{2})"), r"\1 `` "),
]

# punctuation
PUNCTUATION = [
    (re.compile(r"([:,])([^\d])"), r" \1 \2"),
    (re.compile(r"([:,])$"), r" \1 "),
    (re.compile(r"\.\.\."), r" ... "),
    (re.compile(r"[;@#$%&]"), r" \g<0> "),
    (re.compile(r'([^\.])(\.)([\]\)}>"\']*)\s*$'), r"\1 \2\3 "),  # the final period
    (re.compile(r"[?!]"), r" \g<0> "),
    (re.compile(r"([^'])' "), r"\1 ' "),
]

# pads parentheses and brackets
PARENS_BRACKETS = (re.compile(r"[\]\[\(\)\{\}\<\>]"), r" \g<0> ")

DOUBLE_DASHES = (re.compile(r"--"), r" -- ")

# ending quotes
ENDING_QUOTES = [
    (re.compile(r"''"), " '' "),
    (re.compile(r'"'), " '' "),
    (re.compile(r"([^' ])('[sS]|'[mM]|'[dD]|') "), r"\1 \2 "),
    (re.compile(r"([^' ])('ll|'LL|'re|'RE|'ve|'VE|n't|N'T) "), r"\1 \2 "),
]

# contractions adapted from Robert MacIntyre's tokenizer
CONTRACTIONS2 = [re.compile(p) for p in (
    r"(?i)\b(can)(?#X)(not)\b",
    r"(?i)\b(d)(?#X)('ye)\b",
    r"(?i)\b(gim)(?#X)(me)\b",
    r"(?i)\b(gon)(?#X)(na)\b",
    r"(?i)\b(got)(?#X)(ta)\b",
    r"(?i)\b(lem)(?#X)(me)\b",
    r"(?i)\b(more)(?#X)('n)\b",
    r"(?i)\b(wan)(?#X)(na)(?=\s)",
)]
CONTRACTIONS3 = [re.compile(p) for p in (r"(?i) ('t)(?#X)(is)\b", r"(?i) ('t)(?#X)(was)\b")]


def treebank_tokenize(text: str) -> list[str]:
    """The Treebank tokens of ``text``: contractions split (``don't`` ->
    ``do n't``), most punctuation as separate tokens, the final period split
    off, double quotes as ``````/``''``."""
    for regexp, substitution in STARTING_QUOTES:
        text = regexp.sub(substitution, text)
    for regexp, substitution in PUNCTUATION:
        text = regexp.sub(substitution, text)
    regexp, substitution = PARENS_BRACKETS
    text = regexp.sub(substitution, text)
    regexp, substitution = DOUBLE_DASHES
    text = regexp.sub(substitution, text)
    # an extra space at both ends makes the ending rules simpler
    text = " " + text + " "
    for regexp, substitution in ENDING_QUOTES:
        text = regexp.sub(substitution, text)
    for regexp in CONTRACTIONS2:
        text = regexp.sub(r" \1 \2 ", text)
    for regexp in CONTRACTIONS3:
        text = regexp.sub(r" \1 \2 ", text)
    return text.split()
