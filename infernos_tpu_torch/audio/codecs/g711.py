"""G.711 mu-law (PCMU) and A-law (PCMA) codecs.

Capability parity: the reference builds mu-law<->PCM lookup tables with the
(removed-in-3.13) stdlib ``audioop`` at import time and does table-gather
encode/decode on torch tensors (``Core/Codecs/G711.py:7-47``).

Tables are generated **algorithmically in numpy** at import (ITU-T G.711 /
CCITT companding, same math as CPython's audioop), so there is no audioop
dependency here.  Host-side encode/decode is a numpy table gather; the
256-entry decode tables are module constants.  A-law is added beyond the
reference (the reference
negotiates PCMU only, ``SIP/InfernUAC.py:18``) since it is the E1-world
default.
"""

from __future__ import annotations

import numpy as np

from ..chunk import AudioChunk
from .base import GenCodec

_ULAW_BIAS = 0x84
_ULAW_CLIP = 8159  # in the >>2 (14-bit) domain, matching audioop
_SEG_UEND = np.array([0x3F, 0x7F, 0xFF, 0x1FF, 0x3FF, 0x7FF, 0xFFF, 0x1FFF])
_SEG_AEND = np.array([0x1F, 0x3F, 0x7F, 0xFF, 0x1FF, 0x3FF, 0x7FF, 0xFFF])


def _seg(vals: np.ndarray, table: np.ndarray) -> np.ndarray:
    """Segment number = index of first table entry >= val (8 if none)."""
    return np.searchsorted(table, vals, side="left").astype(np.int32)


def _lin2ulaw(pcm: np.ndarray) -> np.ndarray:
    """Vectorized CCITT G.711 mu-law compression of int16 PCM."""
    pcm = pcm.astype(np.int32) >> 2  # 14-bit domain
    mask = np.where(pcm < 0, 0x7F, 0xFF)
    mag = np.minimum(np.abs(pcm), _ULAW_CLIP) + (_ULAW_BIAS >> 2)
    seg = _seg(mag, _SEG_UEND)
    uval = (seg << 4) | ((mag >> (seg + 1)) & 0xF)
    out = np.where(seg >= 8, 0x7F ^ mask, uval ^ mask)
    return out.astype(np.uint8)


def _ulaw2lin(ulaw: np.ndarray) -> np.ndarray:
    """Vectorized mu-law expansion to int16 PCM."""
    u = (~ulaw.astype(np.int32)) & 0xFF
    t = ((u & 0xF) << 3) + _ULAW_BIAS
    t = t << ((u & 0x70) >> 4)
    return np.where(u & 0x80, _ULAW_BIAS - t, t - _ULAW_BIAS).astype(np.int16)


def _lin2alaw(pcm: np.ndarray) -> np.ndarray:
    """Vectorized CCITT G.711 A-law compression of int16 PCM."""
    pcm = pcm.astype(np.int32) >> 3  # 13-bit domain
    mask = np.where(pcm >= 0, 0xD5, 0x55)
    mag = np.where(pcm >= 0, pcm, -pcm - 1)
    seg = _seg(mag, _SEG_AEND)
    shift = np.where(seg < 2, 1, seg)
    aval = (seg << 4) | ((mag >> shift) & 0xF)
    out = np.where(seg >= 8, 0x7F ^ mask, aval ^ mask)
    return out.astype(np.uint8)


def _alaw2lin(alaw: np.ndarray) -> np.ndarray:
    """Vectorized A-law expansion to int16 PCM."""
    a = (alaw.astype(np.int32) ^ 0x55) & 0xFF
    t = (a & 0xF) << 4
    seg = (a & 0x70) >> 4
    t = np.where(seg == 0, t + 8, np.where(seg == 1, t + 0x108, (t + 0x108) << (np.maximum(seg, 1) - 1)))
    return np.where(a & 0x80, t, -t).astype(np.int16)


# Precomputed tables (generated once; reference builds the same shapes at
# import with audioop, ``Core/Codecs/G711.py:7-19``).
ULAW_DECODE_TABLE = _ulaw2lin(np.arange(256, dtype=np.uint8))  # [256] int16
ALAW_DECODE_TABLE = _alaw2lin(np.arange(256, dtype=np.uint8))  # [256] int16
ULAW_DECODE_F32 = (ULAW_DECODE_TABLE.astype(np.float32) / 32767.0)
ALAW_DECODE_F32 = (ALAW_DECODE_TABLE.astype(np.float32) / 32767.0)


class G711Codec(GenCodec):
    """mu-law (PCMU), RTP payload type 0."""

    ptype = 0
    ename = "PCMU"
    _enc = staticmethod(_lin2ulaw)
    _dec_f32 = ULAW_DECODE_F32
    _silence_byte = b"\xff"  # mu-law encoding of 0

    def encode(self, audio: np.ndarray) -> bytes:
        pcm = np.clip(np.asarray(audio) * 32767.0, -32768, 32767).astype(np.int16)
        return self._enc(pcm).tobytes()

    def decode(self, payload: bytes, resample: bool = False, sample_rate: int = 8000) -> np.ndarray:
        idx = np.frombuffer(payload, dtype=np.uint8)
        audio = self._dec_f32[idx]
        if resample and sample_rate != self.srate:
            return AudioChunk(audio, self.srate).resample(sample_rate).audio
        return audio

    def silence(self, nframes: int) -> bytes:
        return self._silence_byte * nframes


class G711ACodec(G711Codec):
    """A-law (PCMA), RTP payload type 8."""

    ptype = 8
    ename = "PCMA"
    _enc = staticmethod(_lin2alaw)
    _dec_f32 = ALAW_DECODE_F32
    _silence_byte = b"\xd5"  # A-law encoding of 0
