"""RTP packet parsing and synthesis (RFC 3550).

Capability parity: replaces the reference's C ``rtpsynth.RtpSynth``
packetizer (``RTP/RTPOutputWorker.py:8,89,135``): header synthesis with
seq/ts management, ``skip()`` advancing the timestamp across idle gaps and
marking the next packet, and the parse side used by the jitter buffer.

This module is the behavioural oracle; the C++ media engine (``native/``)
implements the same wire format for the hot path.
"""

from __future__ import annotations

import secrets
import struct
from dataclasses import dataclass
from typing import Optional


class RTPParseError(Exception):
    pass


@dataclass
class RTPPacket:
    version: int
    marker: bool
    ptype: int
    seq: int
    ts: int
    ssrc: int
    payload: bytes

    @classmethod
    def parse(cls, data: bytes) -> "RTPPacket":
        if len(data) < 12:
            raise RTPParseError(f"short packet: {len(data)}")
        b0, b1, seq, ts, ssrc = struct.unpack("!BBHII", data[:12])
        version = b0 >> 6
        if version != 2:
            raise RTPParseError(f"bad version: {version}")
        cc = b0 & 0x0F
        ext = bool(b0 & 0x10)
        padding = bool(b0 & 0x20)
        off = 12 + 4 * cc
        if ext:
            if len(data) < off + 4:
                raise RTPParseError("truncated extension")
            _, xlen = struct.unpack("!HH", data[off : off + 4])
            off += 4 + 4 * xlen
        if len(data) < off:
            raise RTPParseError("truncated header")
        payload = data[off:]
        if padding and payload:
            pad = payload[-1]
            if pad == 0 or pad > len(payload):
                raise RTPParseError("bad padding")
            payload = payload[:-pad]
        return cls(version, bool(b1 & 0x80), b1 & 0x7F, seq, ts, ssrc, payload)

    def build(self) -> bytes:
        b0 = 2 << 6
        b1 = (0x80 if self.marker else 0) | (self.ptype & 0x7F)
        return struct.pack("!BBHII", b0, b1, self.seq & 0xFFFF,
                           self.ts & 0xFFFFFFFF, self.ssrc) + self.payload


class RTPPacketizer:
    """Outgoing RTP header synthesis with idle-gap handling.

    ``next_pkt(nsamples, pt, payload)`` emits the next packet; ``skip(n)``
    advances the timestamp by ``n`` packet intervals without consuming a
    sequence number (silence suppression) and flags the next packet with the
    marker bit (talkspurt start).
    """

    def __init__(self, clock_rate: int, ptime_ms: int,
                 ssrc: Optional[int] = None, seq0: Optional[int] = None):
        self.clock_rate = clock_rate
        self.ts_per_pkt = clock_rate * ptime_ms // 1000
        self.ssrc = ssrc if ssrc is not None else secrets.randbits(32)
        self.seq = seq0 if seq0 is not None else secrets.randbits(16)
        self.ts = secrets.randbits(32) & 0x7FFFFFFF
        self._marker_next = True  # first packet of a stream marks talkspurt

    def next_pkt(self, nsamples: int, pt: int, payload: bytes) -> bytes:
        pkt = RTPPacket(2, self._marker_next, pt, self.seq, self.ts,
                        self.ssrc, payload)
        self._marker_next = False
        self.seq = (self.seq + 1) & 0xFFFF
        # nsamples is in codec clock units (already = ts units for audio)
        self.ts = (self.ts + nsamples) & 0xFFFFFFFF
        return pkt.build()

    def skip(self, npkts: int = 1) -> None:
        self.ts = (self.ts + npkts * self.ts_per_pkt) & 0xFFFFFFFF
        self._marker_next = True

    def resync(self) -> None:
        self._marker_next = True


def make_packetizer(clock_rate: int, ptime_ms: int):
    """Prefer the C++ packetizer (per-packet hot path); Python fallback."""
    import secrets as _secrets

    from . import native

    if native.available():
        return native.NativePacketizer(
            clock_rate, ptime_ms, ssrc=_secrets.randbits(32),
            seq0=_secrets.randbits(16), ts0=_secrets.randbits(31))
    return RTPPacketizer(clock_rate, ptime_ms)
