"""Byte-level BPE tokenizer engine (Whisper / GPT-2 / Qwen family).

The reference relies on HF tokenizers shipped with each checkpoint
(``Cluster/InfernSTTWorker.py:54`` -- WhisperProcessor;
``Cluster/InfernLLMWorker.py:103-110`` -- Qwen chat template).  The *code*
of those tokenizers is a deterministic algorithm; only the merge tables and
vocab maps are checkpoint data.  Implementing the algorithm here means a
later checkpoint port is data-only: drop ``vocab.json`` + ``merges.txt``
next to the weights and ``ByteLevelBPE.from_files`` serves the exact same
ids as the HF tokenizer.

Pieces:
- ``bytes_to_unicode``: the reversible byte<->printable-unicode map every
  GPT-2-descendant tokenizer uses so merge tables stay readable text.
- ``ByteLevelBPE``: encode (regex pre-split -> greedy lowest-rank merges)
  and decode (ids -> unicode chars -> bytes -> utf-8).
- ``train_bpe``: a small merge-table trainer so in-repo models (tiny
  Whisper/SpeechT5 trained on the synthetic corpus) get a *real* subword
  tokenizer rather than a char/byte stand-in.
"""

from __future__ import annotations

import json
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

# GPT-2's pre-tokenization pattern (also Whisper's).  Qwen2 uses a close
# variant with digit-run splitting; both are supported via `pattern=`.
GPT2_PATTERN = (
    r"'s|'t|'re|'ve|'m|'ll|'d| ?[^\W\d_]+| ?\d+| ?[^\s\w]+|\s+(?!\S)|\s+"
)
# note: python `re` has no \p{L}/\p{N}; [^\W\d_] is the unicode-letter class
# and \d the unicode-digit class under re.UNICODE (default in py3).

QWEN_PATTERN = (
    r"'s|'t|'re|'ve|'m|'ll|'d| ?[^\W\d_]+| ?\d| ?[^\s\w]+|\s+(?!\S)|\s+"
)


def bytes_to_unicode() -> Dict[int, str]:
    """Reversible byte -> printable unicode char map (GPT-2 scheme).

    Printable ASCII + latin-1 blocks map to themselves; the remaining 68
    byte values are assigned to the code points 256, 257, ... in order.
    """
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


_B2U = bytes_to_unicode()
_U2B = {u: b for b, u in _B2U.items()}


def _to_unicode(text: str) -> str:
    return "".join(_B2U[b] for b in text.encode("utf-8"))


def _get_pairs(word: Tuple[str, ...]) -> set:
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


class ByteLevelBPE:
    """Encoder/decoder over a (vocab, merges) pair.

    ``vocab``: token-string (in byte-unicode space) -> id.
    ``merges``: ordered list of (left, right) merge pairs; earlier = applied
    first (lower rank wins).
    """

    def __init__(self, vocab: Dict[str, int],
                 merges: Sequence[Tuple[str, str]],
                 pattern: str = GPT2_PATTERN,
                 special_tokens: Optional[Dict[str, int]] = None):
        self.vocab = dict(vocab)
        self.ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.pattern = re.compile(pattern)
        self.special = dict(special_tokens or {})
        self.id_to_tok = {i: t for t, i in self.vocab.items()}
        for t, i in self.special.items():
            self.id_to_tok.setdefault(i, t)
        self.vocab_size = (max(
            [max(self.vocab.values(), default=-1),
             max(self.special.values(), default=-1)]) + 1)
        self._cache: Dict[str, List[str]] = {}
        if self.special:
            self._special_re = re.compile(
                "(" + "|".join(re.escape(t) for t in sorted(
                    self.special, key=len, reverse=True)) + ")")
        else:
            self._special_re = None

    # -- construction --------------------------------------------------------
    @classmethod
    def from_files(cls, vocab_json: str, merges_txt: str,
                   pattern: str = GPT2_PATTERN,
                   special_tokens: Optional[Dict[str, int]] = None
                   ) -> "ByteLevelBPE":
        """Load the HF on-disk format (vocab.json + merges.txt)."""
        with open(vocab_json, "r", encoding="utf-8") as f:
            vocab = json.load(f)
        merges: List[Tuple[str, str]] = []
        with open(merges_txt, "r", encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line or line.startswith("#version"):
                    continue
                a, _, b = line.partition(" ")
                merges.append((a, b))
        return cls(vocab, merges, pattern, special_tokens)

    def save(self, vocab_json: str, merges_txt: str) -> None:
        with open(vocab_json, "w", encoding="utf-8") as f:
            json.dump(self.vocab, f, ensure_ascii=False)
        inv = sorted(self.ranks.items(), key=lambda kv: kv[1])
        with open(merges_txt, "w", encoding="utf-8") as f:
            f.write("#version: 0.2\n")
            for (a, b), _ in inv:
                f.write(f"{a} {b}\n")

    # -- core BPE ------------------------------------------------------------
    def _bpe(self, token: str) -> List[str]:
        """Apply merges to one pre-token (already in byte-unicode space)."""
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        word: Tuple[str, ...] = tuple(token)
        while len(word) > 1:
            pairs = _get_pairs(word)
            best = min(pairs, key=lambda p: self.ranks.get(p, 1 << 60))
            if best not in self.ranks:
                break
            a, b = best
            out: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            word = tuple(out)
        result = list(word)
        if len(self._cache) < 65536:
            self._cache[token] = result
        return result

    def encode(self, text: str) -> List[int]:
        """Text -> ids.  Special tokens in the text are emitted as their
        reserved ids (HF ``add_special_tokens=False`` + special splitting)."""
        ids: List[int] = []
        if self._special_re is not None:
            segments = self._special_re.split(text)
        else:
            segments = [text]
        for seg in segments:
            if not seg:
                continue
            sid = self.special.get(seg)
            if sid is not None:
                ids.append(sid)
                continue
            for m in self.pattern.findall(seg):
                for piece in self._bpe(_to_unicode(m)):
                    tid = self.vocab.get(piece)
                    if tid is None:
                        # unknown piece: fall back to per-byte tokens
                        for ch in piece:
                            bid = self.vocab.get(ch)
                            if bid is not None:
                                ids.append(bid)
                    else:
                        ids.append(tid)
        return ids

    def decode(self, ids: Iterable[int], skip_special: bool = True) -> str:
        chars: List[str] = []
        for i in ids:
            tok = self.id_to_tok.get(int(i))
            if tok is None:
                continue
            if int(i) in self.special.values() or tok in self.special:
                if skip_special:
                    continue
                chars.append(tok)
                continue
            chars.append(tok)
        bs = bytearray()
        for tok in chars:
            for ch in tok:
                b = _U2B.get(ch)
                if b is None:  # special token text passed through
                    bs.extend(ch.encode("utf-8"))
                else:
                    bs.append(b)
        return bs.decode("utf-8", "replace")

    # -- adapter interface (matches CharTokenizer/ByteTokenizer) -------------
    def __call__(self, text: str) -> np.ndarray:
        return np.asarray(self.encode(text), np.int32)

    def detokenize(self, ids: Sequence[int]) -> str:
        return self.decode(ids)


def train_bpe(corpus: Iterable[str], vocab_size: int,
              pattern: str = GPT2_PATTERN,
              special_tokens: Optional[Sequence[str]] = None
              ) -> ByteLevelBPE:
    """Train a byte-level BPE merge table (the classic greedy algorithm).

    Small-scale trainer for in-repo tiny models: count pre-token
    frequencies, then repeatedly merge the most frequent adjacent pair
    until ``vocab_size`` is reached.  Specials are appended after byte and
    merge tokens, matching GPT-2 layout (byte alphabet first).
    """
    pat = re.compile(pattern)
    # pre-token frequency table, words as tuples of byte-unicode chars
    freqs: Dict[Tuple[str, ...], int] = {}
    for line in corpus:
        for m in pat.findall(line):
            w = tuple(_to_unicode(m))
            freqs[w] = freqs.get(w, 0) + 1

    vocab: Dict[str, int] = {}
    for _, u in sorted(_B2U.items()):
        vocab[u] = len(vocab)
    merges: List[Tuple[str, str]] = []
    n_special = len(special_tokens or ())
    max_merges = max(0, vocab_size - len(vocab) - n_special)

    words = {w: c for w, c in freqs.items()}
    for _ in range(max_merges):
        pair_counts: Dict[Tuple[str, str], int] = {}
        for w, c in words.items():
            for i in range(len(w) - 1):
                p = (w[i], w[i + 1])
                pair_counts[p] = pair_counts.get(p, 0) + c
        if not pair_counts:
            break
        # deterministic tie-break: count desc, then lexicographic
        best = max(pair_counts.items(), key=lambda kv: (kv[1], kv[0]))[0]
        if pair_counts[best] < 2:
            break
        merges.append(best)
        a, b = best
        ab = a + b
        vocab[ab] = len(vocab)
        new_words: Dict[Tuple[str, ...], int] = {}
        for w, c in words.items():
            if a not in w:
                new_words[w] = new_words.get(w, 0) + c
                continue
            out: List[str] = []
            i = 0
            while i < len(w):
                if i < len(w) - 1 and w[i] == a and w[i + 1] == b:
                    out.append(ab)
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            t = tuple(out)
            new_words[t] = new_words.get(t, 0) + c
        words = new_words

    special_map = {t: len(vocab) + i
                   for i, t in enumerate(special_tokens or ())}
    return ByteLevelBPE(vocab, merges, pattern, special_map)
