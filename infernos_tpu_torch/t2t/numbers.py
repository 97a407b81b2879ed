"""Digits-to-words normalization for TTS input.

Capability parity with the reference's ``Core/T2T/NumbersToWords.py``: finds
numbers (including ``%`` and trailing punctuation) in text and replaces them
with words, optionally translating the words for non-English targets; per-
number translation results are cached.  The reference uses the ``inflect``
package; this is a self-contained English realization (no deps).
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Optional

_ONES = ("zero one two three four five six seven eight nine ten eleven twelve "
         "thirteen fourteen fifteen sixteen seventeen eighteen nineteen").split()
_TENS = ("", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety")
_SCALE = [(10**9, "billion"), (10**6, "million"), (10**3, "thousand"),
          (100, "hundred")]


def _int_to_words(n: int) -> str:
    if n < 0:
        return "minus " + _int_to_words(-n)
    if n < 20:
        return _ONES[n]
    if n < 100:
        t, r = divmod(n, 10)
        return _TENS[t] + ("-" + _ONES[r] if r else "")
    for base, name in _SCALE:
        if n >= base:
            major, rest = divmod(n, base)
            out = _int_to_words(major) + " " + name
            if rest:
                joiner = " and " if rest < 100 and base == 100 else " "
                out += joiner + _int_to_words(rest)
            return out
    return _ONES[0]


def number_to_words(token: str) -> str:
    """'1,234.5' -> 'one thousand two hundred and thirty-four point five'."""
    token = token.replace(",", "")
    if "." in token:
        ip, fp = token.split(".", 1)
        words = _int_to_words(int(ip or "0")) + " point " + \
            " ".join(_ONES[int(d)] for d in fp if d.isdigit())
        return words
    return _int_to_words(int(token))


class NumbersToWords:
    """Replace digit groups in text with spelled-out words."""

    _NUM_RE = re.compile(r"\b\d[\d.,]*%?(?=[\s.,!?]|$)")

    def __init__(self, lang: str = "en",
                 translate: Optional[Callable[[str], str]] = None):
        self.lang = lang
        self.translate = translate if lang != "en" else None
        self.cache: Dict[str, str] = {}

    def __call__(self, text: str) -> str:
        for number in self._NUM_RE.findall(text):
            suffix = ""
            core = number
            if core.endswith("%"):
                core, suffix = core[:-1], " percent"
            elif core[-1] in ".,!":
                core, suffix = core[:-1], core[-1]
            word = number_to_words(core) + suffix
            if self.translate is not None:
                cached = self.cache.get(number)
                if cached is None:
                    cached = self.cache[number] = self.translate(word)
                word = cached
            text = text.replace(number, word, 1)
        return text
