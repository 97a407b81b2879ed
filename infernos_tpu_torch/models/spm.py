"""SentencePiece (unigram) tokenizer: decoder, Viterbi encoder, and a
minimal ``.model`` protobuf reader.

The reference's SpeechT5 processor tokenizes text with a SentencePiece
model shipped in the checkpoint (``Cluster/InfernTTSWorker.py:37-45`` via
``SpeechT5Processor``).  The algorithm is deterministic; only the piece
table is data.  This module implements:

- ``SentencePieceModel``: piece table + scores; ``decode`` (ids -> text,
  U+2581 -> space) and ``encode`` (Viterbi best segmentation under piece
  log-probs, the standard unigram inference).
- ``load_spm_model``: a wire-format protobuf reader for the standard
  ``spiece.model`` ModelProto (repeated field 1 = SentencePiece{piece=1,
  score=2, type=3}) so a checkpoint port needs zero extra deps.
- ``train_char_spm``: builds a char-level piece table from a corpus --
  exactly the shape of SpeechT5's 81-token vocab -- for in-repo models.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

WS = "▁"  # SentencePiece whitespace marker

# piece types from sentencepiece.proto
_NORMAL, _UNKNOWN, _CONTROL, _USER_DEFINED, _BYTE, _UNUSED = 1, 2, 3, 4, 6, 5


class SentencePieceModel:
    def __init__(self, pieces: Sequence[Tuple[str, float, int]]):
        """pieces: (piece, score, type) in id order."""
        self.pieces = list(pieces)
        self.piece_to_id = {p: i for i, (p, _, _) in enumerate(self.pieces)}
        self.vocab_size = len(self.pieces)
        self.unk_id = next((i for i, (_, _, t) in enumerate(self.pieces)
                            if t == _UNKNOWN), 0)
        self._max_len = max((len(p) for p, _, t in self.pieces
                             if t in (_NORMAL, _USER_DEFINED)), default=1)

    # -- decode --------------------------------------------------------------
    def decode(self, ids: Iterable[int]) -> str:
        out: List[str] = []
        for i in ids:
            i = int(i)
            if not 0 <= i < len(self.pieces):
                continue
            piece, _, typ = self.pieces[i]
            if typ in (_CONTROL, _UNUSED):
                continue
            if typ == _UNKNOWN:
                out.append(" ⁇ ")  # spm's unk surface
                continue
            if typ == _BYTE:  # "<0xNN>"
                try:
                    out.append(chr(int(piece[3:5], 16)))
                except ValueError:
                    pass
                continue
            out.append(piece)
        text = "".join(out).replace(WS, " ")
        return text[1:] if text.startswith(" ") else text

    # -- encode (unigram Viterbi) -------------------------------------------
    def encode(self, text: str, add_ws_prefix: bool = True) -> List[int]:
        s = text.replace(" ", WS)
        if add_ws_prefix and not s.startswith(WS):
            s = WS + s
        n = len(s)
        NEG = -1e18
        best = [NEG] * (n + 1)
        back: List[Optional[Tuple[int, int]]] = [None] * (n + 1)
        best[0] = 0.0
        unk_score = (self.pieces[self.unk_id][1]
                     if self.pieces else -10.0) - 10.0
        for i in range(n):
            if best[i] <= NEG / 2:
                continue
            hi = min(n, i + self._max_len)
            for j in range(i + 1, hi + 1):
                pid = self.piece_to_id.get(s[i:j])
                if pid is None:
                    continue
                sc = best[i] + self.pieces[pid][1]
                if sc > best[j]:
                    best[j] = sc
                    back[j] = (i, pid)
            # unk fallback: single char
            sc = best[i] + unk_score
            if sc > best[i + 1]:
                best[i + 1] = sc
                back[i + 1] = (i, self.unk_id)
        ids: List[int] = []
        j = n
        while j > 0:
            step = back[j]
            if step is None:  # unreachable, bail to unk
                ids.append(self.unk_id)
                j -= 1
                continue
            i, pid = step
            ids.append(pid)
            j = i
        ids.reverse()
        return ids

    # -- adapter interface ---------------------------------------------------
    def __call__(self, text: str) -> np.ndarray:
        return np.asarray(self.encode(text), np.int32)

    def detokenize(self, ids: Sequence[int]) -> str:
        return self.decode(ids)


# -- protobuf wire-format reader (no protobuf dep) ---------------------------

def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _skip_field(buf: bytes, pos: int, wire: int) -> int:
    if wire == 0:
        _, pos = _read_varint(buf, pos)
    elif wire == 1:
        pos += 8
    elif wire == 2:
        ln, pos = _read_varint(buf, pos)
        pos += ln
    elif wire == 5:
        pos += 4
    else:
        raise ValueError(f"unsupported wire type {wire}")
    return pos


def _parse_sentencepiece(buf: bytes) -> Tuple[str, float, int]:
    import struct

    piece, score, typ = "", 0.0, _NORMAL
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:  # piece
            ln, pos = _read_varint(buf, pos)
            piece = buf[pos:pos + ln].decode("utf-8")
            pos += ln
        elif field == 2 and wire == 5:  # score (float)
            score = struct.unpack("<f", buf[pos:pos + 4])[0]
            pos += 4
        elif field == 3 and wire == 0:  # type
            typ, pos = _read_varint(buf, pos)
        else:
            pos = _skip_field(buf, pos, wire)
    return piece, score, typ


def load_spm_model(path: str) -> SentencePieceModel:
    """Read a standard ``spiece.model`` (SentencePiece ModelProto)."""
    with open(path, "rb") as f:
        buf = f.read()
    pieces: List[Tuple[str, float, int]] = []
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:  # repeated SentencePiece pieces
            ln, pos = _read_varint(buf, pos)
            pieces.append(_parse_sentencepiece(buf[pos:pos + ln]))
            pos += ln
        else:
            pos = _skip_field(buf, pos, wire)
    return SentencePieceModel(pieces)


def save_spm_model(model: SentencePieceModel, path: str) -> None:
    """Write the piece table back out as a minimal ModelProto."""
    import struct

    def varint(v: int) -> bytes:
        out = bytearray()
        while True:
            b = v & 0x7F
            v >>= 7
            if v:
                out.append(b | 0x80)
            else:
                out.append(b)
                return bytes(out)

    blob = bytearray()
    for piece, score, typ in model.pieces:
        pb = bytearray()
        pdata = piece.encode("utf-8")
        pb += varint((1 << 3) | 2) + varint(len(pdata)) + pdata
        pb += varint((2 << 3) | 5) + struct.pack("<f", score)
        pb += varint((3 << 3) | 0) + varint(typ)
        blob += varint((1 << 3) | 2) + varint(len(pb)) + bytes(pb)
    with open(path, "wb") as f:
        f.write(bytes(blob))


def train_char_spm(corpus: Iterable[str],
                   control: Sequence[str] = ("<pad>", "<s>", "</s>"),
                   ) -> SentencePieceModel:
    """Char-level unigram table from corpus frequencies (SpeechT5 shape:
    specials + unk + chars with log-prob scores)."""
    counts: Dict[str, int] = {}
    total = 0
    for line in corpus:
        for ch in line.replace(" ", WS):
            counts[ch] = counts.get(ch, 0) + 1
            total += 1
    pieces: List[Tuple[str, float, int]] = []
    for c in control:
        pieces.append((c, 0.0, _CONTROL))
    pieces.append(("<unk>", -10.0, _UNKNOWN))
    for ch, n in sorted(counts.items(), key=lambda kv: (-kv[1], kv[0])):
        pieces.append((ch, math.log(n / max(1, total)), _NORMAL))
    return SentencePieceModel(pieces)
