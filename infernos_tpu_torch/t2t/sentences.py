"""Sentence splitting and regrouping for streaming TTS.

Capability parity: the reference sent_tokenizes translated text and re-merges
short sentences into <=128-char groups before TTS
(``Apps/LiveTranslator/LTSession.py:204-228``).  nltk's punkt model is not
available offline, so this uses a robust regex splitter with abbreviation
guards; the function signature stays tokenizer-agnostic.
"""

from __future__ import annotations

import re
from typing import List

_ABBREV = {"mr", "mrs", "ms", "dr", "prof", "sr", "jr", "st", "vs", "etc",
           "e.g", "i.e", "inc", "ltd", "co", "corp", "no", "dept"}

_SPLIT_RE = re.compile(r"(?<=[.!?])\s+(?=[A-Z\"'(\[0-9])")


def sent_split(text: str) -> List[str]:
    """Split text into sentences; abbreviation-aware, punctuation-preserving."""
    parts = _SPLIT_RE.split(text.strip())
    out: List[str] = []
    for p in parts:
        p = p.strip()
        if not p:
            continue
        if out:
            prev = out[-1]
            last_word = prev.rstrip(".!?").rsplit(" ", 1)[-1].lower()
            if last_word in _ABBREV or (len(last_word) == 1 and prev.endswith(".")):
                out[-1] = prev + " " + p
                continue
        out.append(p)
    return out


def regroup_sentences(sentences: List[str], max_chars: int = 128) -> List[str]:
    """Merge consecutive sentences into groups of <= max_chars (reference
    128-char merge, ``LTSession.py:215-221``)."""
    groups: List[str] = []
    cur = ""
    for s in sentences:
        if not cur:
            cur = s
        elif len(cur) + 1 + len(s) <= max_chars:
            cur = cur + " " + s
        else:
            groups.append(cur)
            cur = s
    if cur:
        groups.append(cur)
    return groups
