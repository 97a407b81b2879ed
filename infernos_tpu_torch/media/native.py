"""ctypes bindings to the C++ media engine (``csrc/rtp_engine.cpp``).

Capability parity: the native replacements for the reference's C
dependencies -- rtpsynth (jitter buffer + packetizer), G722, audioop tables.
Every binding has a pure-Python behavioural oracle in this package.

The engine is compiled with ``g++`` at first use into
``build/librtpengine.so`` of this package (git-ignored), through a
temporary name that is renamed into place, so processes that build at once
never load a half-written file.  Nothing is written outside ``build/``.
:func:`available` is False when the build or the load failed, and
:func:`load_error` then says why.  The jitter buffer and packetizer
factories then take their Python oracles; an endpoint refuses to start
unless ``INFERNOS_NATIVE_PACER=0`` asks for the Python pacer.
"""

from __future__ import annotations

import ctypes
import os
import struct
import subprocess
from typing import List, Optional

import numpy as np

from ..utils.logging import get_logger
from .jitter import JBFrame, RTPFrameType

log = get_logger("media.native")

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(PKG_DIR, "csrc", "rtp_engine.cpp")
LIB = os.path.join(PKG_DIR, "build", "librtpengine.so")

_lib: Optional[ctypes.CDLL] = None
_tried = False
_error: Optional[str] = None


def build() -> str:
    """Compile ``csrc/rtp_engine.cpp`` when the library is missing or older
    than its source; returns the library's path.  Raises on a failed build."""
    if os.path.exists(LIB) and os.path.getmtime(LIB) >= os.path.getmtime(SRC):
        return LIB
    os.makedirs(os.path.dirname(LIB), exist_ok=True)
    tmp = f"{LIB}.tmp{os.getpid()}"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
           "-o", tmp, SRC]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed (rc {res.returncode}):\n{res.stderr}")
        os.replace(tmp, LIB)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return LIB


def load_error() -> Optional[str]:
    """Why the engine is unavailable (None when it loaded or was not tried)."""
    _load()
    return _error


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, _error
    if _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(build())
    except Exception as e:
        _error = f"{type(e).__name__}: {e}"
        log.warning("native media engine unavailable (%s)", e)
        return None
    # -- signatures -----------------------------------------------------------
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i16p = ctypes.POINTER(ctypes.c_int16)
    lib.g711_ulaw_encode.argtypes = [i16p, u8p, ctypes.c_int]
    lib.g711_ulaw_decode.argtypes = [u8p, i16p, ctypes.c_int]
    lib.g711_alaw_encode.argtypes = [i16p, u8p, ctypes.c_int]
    lib.g711_alaw_decode.argtypes = [u8p, i16p, ctypes.c_int]
    lib.g722_new.restype = ctypes.c_void_p
    lib.g722_free.argtypes = [ctypes.c_void_p]
    lib.g722_encode.argtypes = [ctypes.c_void_p, i16p, ctypes.c_int, u8p]
    lib.g722_encode.restype = ctypes.c_int
    lib.g722_decode.argtypes = [ctypes.c_void_p, u8p, ctypes.c_int, i16p]
    lib.g722_decode.restype = ctypes.c_int
    lib.rtp_packetizer_new.restype = ctypes.c_void_p
    lib.rtp_packetizer_new.argtypes = [ctypes.c_uint32, ctypes.c_uint32,
                                       ctypes.c_uint32, ctypes.c_uint16,
                                       ctypes.c_uint32]
    lib.rtp_packetizer_free.argtypes = [ctypes.c_void_p]
    lib.rtp_next_pkt.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                                 ctypes.c_uint8, u8p, ctypes.c_int, u8p]
    lib.rtp_next_pkt.restype = ctypes.c_int
    lib.rtp_skip.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
    lib.rtp_packetizer_ts.argtypes = [ctypes.c_void_p]
    lib.rtp_packetizer_ts.restype = ctypes.c_uint32
    lib.jbuf_new.restype = ctypes.c_void_p
    lib.jbuf_new.argtypes = [ctypes.c_int]
    lib.jbuf_free.argtypes = [ctypes.c_void_p]
    lib.jbuf_udp_in.argtypes = [ctypes.c_void_p, u8p, ctypes.c_int, u8p,
                                ctypes.c_int]
    lib.jbuf_udp_in.restype = ctypes.c_int
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.pacer_new.restype = ctypes.c_void_p
    lib.pacer_new.argtypes = [ctypes.c_uint32]
    lib.pacer_free.argtypes = [ctypes.c_void_p]
    lib.pacer_add_leg.restype = ctypes.c_int
    lib.pacer_add_leg.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_uint8, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_uint16, ctypes.c_uint32]
    lib.pacer_set_dest.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_char_p, ctypes.c_uint16]
    lib.pacer_remove_leg.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.pacer_write.argtypes = [ctypes.c_void_p, ctypes.c_int, u8p,
                                ctypes.c_int]
    lib.pacer_leg_sent_bytes.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.pacer_leg_sent_bytes.restype = ctypes.c_uint64
    lib.pacer_leg_buffered.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.pacer_leg_buffered.restype = ctypes.c_uint64
    lib.pacer_leg_stats.argtypes = [ctypes.c_void_p, ctypes.c_int, u64p]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _as_u8(b: bytes):
    return ctypes.cast(ctypes.create_string_buffer(b, len(b)),
                       ctypes.POINTER(ctypes.c_uint8))


# -- G.711 -----------------------------------------------------------------------

def ulaw_encode(pcm: np.ndarray) -> bytes:
    lib = _load()
    pcm = np.ascontiguousarray(pcm, np.int16)
    out = np.empty(len(pcm), np.uint8)
    lib.g711_ulaw_encode(pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                         out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                         len(pcm))
    return out.tobytes()


def ulaw_decode(data: bytes) -> np.ndarray:
    lib = _load()
    src = np.frombuffer(data, np.uint8)
    out = np.empty(len(src), np.int16)
    lib.g711_ulaw_decode(np.ascontiguousarray(src).ctypes.data_as(
        ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), len(src))
    return out


def alaw_encode(pcm: np.ndarray) -> bytes:
    lib = _load()
    pcm = np.ascontiguousarray(pcm, np.int16)
    out = np.empty(len(pcm), np.uint8)
    lib.g711_alaw_encode(pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                         out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                         len(pcm))
    return out.tobytes()


def alaw_decode(data: bytes) -> np.ndarray:
    lib = _load()
    src = np.frombuffer(data, np.uint8)
    out = np.empty(len(src), np.int16)
    lib.g711_alaw_decode(np.ascontiguousarray(src).ctypes.data_as(
        ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), len(src))
    return out


# -- G.722 -----------------------------------------------------------------------

class NativeG722:
    def __init__(self):
        self._lib = _load()
        self._state = self._lib.g722_new()

    def __del__(self):
        if getattr(self, "_state", None):
            self._lib.g722_free(self._state)
            self._state = None

    def encode(self, pcm: np.ndarray) -> bytes:
        pcm = np.ascontiguousarray(pcm, np.int16)
        out = np.empty(len(pcm) // 2, np.uint8)
        n = self._lib.g722_encode(
            self._state,
            pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), len(pcm),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return out[:n].tobytes()

    def decode(self, data: bytes) -> np.ndarray:
        src = np.ascontiguousarray(np.frombuffer(data, np.uint8))
        out = np.empty(len(src) * 2, np.int16)
        n = self._lib.g722_decode(
            self._state,
            src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(src),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)))
        return out[:n]


# -- RTP packetizer -----------------------------------------------------------------

class NativePacketizer:
    def __init__(self, clock_rate: int, ptime_ms: int, ssrc: int = 0,
                 seq0: int = 0, ts0: int = 0):
        self._lib = _load()
        self._state = self._lib.rtp_packetizer_new(clock_rate, ptime_ms,
                                                   ssrc, seq0, ts0)

    def __del__(self):
        if getattr(self, "_state", None):
            self._lib.rtp_packetizer_free(self._state)
            self._state = None

    def next_pkt(self, nsamples: int, pt: int, payload: bytes) -> bytes:
        out = np.empty(12 + len(payload), np.uint8)
        src = np.ascontiguousarray(np.frombuffer(payload, np.uint8))
        n = self._lib.rtp_next_pkt(
            self._state, nsamples, pt,
            src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(payload),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return out[:n].tobytes()

    def skip(self, npkts: int = 1) -> None:
        self._lib.rtp_skip(self._state, npkts)

    @property
    def ts(self) -> int:
        """Media-clock timestamp; mirrors the Python packetizer's ``ts``
        attribute so RTCP SR generation works on either implementation."""
        return int(self._lib.rtp_packetizer_ts(self._state))


# -- jitter buffer ---------------------------------------------------------------------

_REC_HDR = struct.Struct("<bqqII")


class NativeJitterBuffer:
    """Drop-in for ``media.jitter.JitterBuffer`` backed by the C++ engine."""

    def __init__(self, size: int = 8):
        self._lib = _load()
        self._state = self._lib.jbuf_new(size)
        self._out = np.empty(65536, np.uint8)

    def __del__(self):
        if getattr(self, "_state", None):
            self._lib.jbuf_free(self._state)
            self._state = None

    def udp_in(self, data: bytes) -> List[JBFrame]:
        from .rtp import RTPParseError

        src = np.ascontiguousarray(np.frombuffer(data, np.uint8))
        n = self._lib.jbuf_udp_in(
            self._state,
            src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(src),
            self._out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            len(self._out))
        if n < 0:
            raise RTPParseError("native parse error")
        frames: List[JBFrame] = []
        buf = self._out[:n].tobytes()
        off = 0
        while off < n:
            typ, lseq, lseq_start, ts_diff, plen = _REC_HDR.unpack_from(buf, off)
            off += _REC_HDR.size
            payload = buf[off : off + plen]
            off += plen
            if typ == 0:
                frames.append(JBFrame(RTPFrameType.AUDIO, lseq=lseq,
                                      rtp_data=payload))
            else:
                frames.append(JBFrame(RTPFrameType.ERS, lseq=lseq,
                                      lseq_start=lseq_start, lseq_end=lseq,
                                      ts_diff=ts_diff))
        return frames
