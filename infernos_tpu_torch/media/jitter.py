"""RTP jitter buffer with reordering and explicit gap (ERS) frames.

Capability parity: replaces the C ``rtpsynth.RtpJBuf``
(``RTP/InfernRTPIngest.py:6,77-97``).  Contract observed by the reference's
consumer:

- frames come out in strictly increasing local sequence (``lseq``); the
  consumer asserts ``lseq == last_output_lseq + 1``
  (``InfernRTPIngest.py:93``);
- lost packets surface as one **ERS** frame carrying ``lseq_start`` /
  ``lseq_end`` of the missing range and ``ts_diff`` (missing samples), which
  the consumer fills with codec silence (``InfernRTPIngest.py:86-90``);
- duplicates and too-late packets are dropped; reordering is absorbed up to
  ``size`` packets of depth.

This Python implementation is the oracle for the C++ engine in ``native/``.
"""

from __future__ import annotations

import dataclasses
from enum import Enum
from typing import Dict, List, Optional

from .rtp import RTPPacket


class RTPFrameType(Enum):
    AUDIO = 0
    ERS = 1


@dataclasses.dataclass
class JBFrame:
    type: RTPFrameType
    lseq: int  # AUDIO: this frame's lseq; ERS: == lseq_end
    rtp_data: bytes = b""
    ts: int = 0
    marker: bool = False
    # ERS fields
    lseq_start: int = 0
    lseq_end: int = 0
    ts_diff: int = 0  # missing samples (RTP clock units)


class JitterBuffer:
    """Sequence-reordering buffer with ADAPTIVE depth.

    ``size`` is the maximum reorder depth; the effective depth tracks the
    observed reorder distance (decaying max, 0.995/packet), so on clean
    streams a loss is declared after just ``min_size`` buffered packets
    (~40 ms at 20 ms ptime) instead of ``size`` (~160 ms), while messy
    networks still get the full absorption.  The adaptation is a pure
    function of the packet sequence, so the C++ engine implements the
    identical rule and stays byte-parity with this oracle.
    """

    min_size = 2

    def __init__(self, size: int = 8):
        self.size = size
        self._buf: Dict[int, RTPPacket] = {}  # eseq -> packet
        self._base_seq: Optional[int] = None
        self._cycles = 0
        self._last_seq: Optional[int] = None  # last raw 16-bit seq seen
        self._next_eseq: Optional[int] = None  # next extended seq to release
        self._last_ts: Optional[int] = None  # ts of last released packet
        self._last_dur: int = 0  # payload samples of last released packet
        self.ssrc: Optional[int] = None
        self._reorder_depth = 0.0  # decaying max of observed reorder distance
        self._max_eseq: Optional[int] = None

    # -- sequence unwrapping -------------------------------------------------
    def _extend(self, seq: int) -> int:
        if self._last_seq is None:
            self._last_seq = seq
            return self._cycles + seq
        delta = (seq - self._last_seq) & 0xFFFF
        if delta < 0x8000:  # forward (or equal)
            if seq < self._last_seq:
                self._cycles += 0x10000
            self._last_seq = seq
            return self._cycles + seq
        # backward (late packet); may straddle a wrap
        if seq > self._last_seq:
            return self._cycles - 0x10000 + seq
        return self._cycles + seq

    def _pkt_samples(self, pkt: RTPPacket) -> int:
        # For the codecs in scope (G.711: 1 byte/sample; G.722: RTP ts runs
        # at 8 kHz = 1 byte/ts-unit) payload bytes == timestamp units.
        return len(pkt.payload)

    # -- main entry -----------------------------------------------------------
    def udp_in(self, data: bytes) -> List[JBFrame]:
        pkt = RTPPacket.parse(data)
        if self.ssrc is None:
            self.ssrc = pkt.ssrc
        elif pkt.ssrc != self.ssrc:
            # SSRC change: treat as stream reset
            self.__init__(self.size)
            self.ssrc = pkt.ssrc
        eseq = self._extend(pkt.seq)
        # adaptive depth bookkeeping (mirrored exactly in the C++ engine)
        if self._max_eseq is None or eseq > self._max_eseq:
            self._max_eseq = eseq
        else:
            dist = float(self._max_eseq - eseq)
            if dist > self._reorder_depth:
                self._reorder_depth = dist
        self._reorder_depth *= 0.995
        if self._next_eseq is None:
            self._next_eseq = eseq
        if eseq < self._next_eseq or eseq in self._buf:
            return []  # late duplicate
        self._buf[eseq] = pkt
        return self._drain()

    def _effective_size(self) -> int:
        eff = int(self._reorder_depth) + 1
        if eff < self.min_size:
            eff = self.min_size
        if eff > self.size:
            eff = self.size
        return eff

    def _drain(self) -> List[JBFrame]:
        out: List[JBFrame] = []
        while self._buf:
            nxt = self._next_eseq
            if nxt in self._buf:
                pkt = self._buf.pop(nxt)
                out.append(JBFrame(RTPFrameType.AUDIO, lseq=nxt,
                                   rtp_data=pkt.payload, ts=pkt.ts,
                                   marker=pkt.marker))
                self._last_ts = pkt.ts
                self._last_dur = self._pkt_samples(pkt)
                self._next_eseq = nxt + 1
                continue
            # head missing: wait until the buffer exceeds the ADAPTIVE
            # reorder depth (observed distance + 1, clamped [min_size, size])
            if len(self._buf) < self._effective_size():
                break
            first_avail = min(self._buf)
            first_pkt = self._buf[first_avail]
            if self._last_ts is not None:
                ts_diff = (first_pkt.ts - (self._last_ts + self._last_dur)) & 0xFFFFFFFF
                if ts_diff > 1 << 30:  # ts went backwards; fall back to count
                    ts_diff = (first_avail - nxt) * self._last_dur
            else:
                ts_diff = (first_avail - nxt) * self._pkt_samples(first_pkt)
            out.append(JBFrame(RTPFrameType.ERS, lseq=first_avail - 1,
                               lseq_start=nxt, lseq_end=first_avail - 1,
                               ts_diff=int(ts_diff)))
            self._next_eseq = first_avail
        return out


def make_jitter_buffer(size: int = 8):
    """Prefer the C++ jitter buffer (hot path); fall back to Python."""
    from . import native

    if native.available():
        return native.NativeJitterBuffer(size)
    return JitterBuffer(size)
