"""RTP endpoint: one per call leg, tying UDP <-> jitter/VAD <-> pacer.

Capability parity with ``RTP/InfernRTPEPoint.py``: owns the paced output
writer (the native pacer's leg; the Python worker only when
``INFERNOS_NATIVE_PACER=0`` asks for it) and the inbound stream, binds a
UDP socket from the port allocator, filters received packets by source
address (``:49-56``), swaps the output worker when ptime/codec changes on
re-INVITE (``update()``, ``:58-66``), and forwards chunks/markers to the
writer (``soundout()``, ``:81-91``).
"""

from __future__ import annotations

import os
import uuid as uuid_mod
from dataclasses import dataclass
from typing import Optional, Tuple, Type, Union

from ..audio.chunk import AudioChunk
from ..audio.markers import ASMarkerGeneric
from ..utils.logging import get_logger
from .ingest import AudioInput, RTPInStream, RTPIngest
from .pacer import RTPOutputWorker
from .udp import RTPPortAllocator

log = get_logger("media.endpoint")


@dataclass
class RTPParams:
    """Negotiated media parameters (reference ``RTP/RTPParams.py:5-13``)."""

    rtp_target: Optional[Tuple[str, int]]
    codec: Type  # codec class (GenCodec subclass)
    out_ptime: int = 20


def native_pacer() -> bool:
    """Whether legs ride the native pacer loop: yes unless
    ``INFERNOS_NATIVE_PACER`` is ``0`` or empty, the explicit switch to the
    Python worker.  Without the switch, an engine that did not build or
    load is an error, not a silent change of pacer."""
    if os.environ.get("INFERNOS_NATIVE_PACER", "1") in ("", "0"):
        return False
    from . import native

    if not native.available():
        raise RuntimeError(
            f"native media engine unavailable ({native.load_error()}); set "
            "INFERNOS_NATIVE_PACER=0 to pace legs with the Python worker")
    return True


class RTPEndpoint:
    """One call leg's media endpoint."""

    def __init__(self, ring: RTPIngest, params: RTPParams,
                 allocator: RTPPortAllocator, bind_ip: str = "127.0.0.1",
                 get_direct_soundout=None):
        self.id = uuid_mod.uuid4()
        self.ring = ring
        self.params = params
        self.allocator = allocator
        self.firstframe = True
        self._native = native_pacer()  # raises before any socket is bound
        codec = params.codec()
        self.stream_in = RTPInStream(ring, codec,
                                     get_direct_soundout=get_direct_soundout)
        self.udp = allocator.bind_server(bind_ip, self._rtp_received)
        self._writer_dest = params.rtp_target
        self.writer = self._make_writer(params)
        self.writer.start()
        # RTCP on rtp_port+1 (beyond-reference; see media/rtcp.py)
        self.rtcp = None
        try:
            from . import rtcp as rtcp_m
            from .udp import UdpServer

            self._rx_stats = rtcp_m.RxStats(clock_rate=codec.srate)
            rtcp_sock = UdpServer((bind_ip, self.udp.laddr[1] + 1),
                                  self._rtcp_received)
            self.rtcp = rtcp_m.RTCPSession(rtcp_sock, self._rx_stats,
                                           self._tx_stats)
            if params.rtp_target is not None:
                self.rtcp.target = (params.rtp_target[0],
                                    params.rtp_target[1] + 1)
        except OSError:
            self._rx_stats = None  # port+1 taken: leg runs without RTCP

    def _make_writer(self, params: RTPParams):
        """The native single-loop pacer's leg, or with
        ``INFERNOS_NATIVE_PACER=0`` the Python thread-per-leg worker."""
        from . import cpacer

        if self._native:
            leg = cpacer.shared_loop().new_leg(
                params.codec(), self.udp.sock.fileno(),
                ptime_ms=params.out_ptime)
            if params.rtp_target is not None:
                leg.set_dest(params.rtp_target)
            return leg
        return RTPOutputWorker(params.codec(), self._send_pkt,
                               ptime_ms=params.out_ptime)

    def _rtcp_received(self, data: bytes, address, rtime: float) -> None:
        if self.rtcp is not None:
            self.rtcp.on_rtcp(data, address, rtime)

    def _tx_stats(self):
        """(pkt_count, octet_count, rtp_ts) for RTCP SRs, from either writer.

        The third element is the packetizer's actual media-clock timestamp
        (keeps advancing across idle skips), not a byte counter -- a byte
        count is only coincidentally an RTP ts for G.711 and freezes during
        silence, drifting the peer's NTP<->RTP mapping."""
        w = self.writer
        if hasattr(w, "stats"):  # native leg
            st = w.stats()
            return st["sent_pkts"], st["sent_bytes"], st["rtp_ts"]
        return w.sent_pkts, w.sent_bytes, w.rtp_ts

    # -- rx ------------------------------------------------------------------
    def _rtp_received(self, data: bytes, address, rtime: float) -> None:
        if self.params.rtp_target is not None:
            # source-address filter: both host and port must match
            if (address[0] != self.params.rtp_target[0]
                    or address[1] != self.params.rtp_target[1]):
                return
        # stats AFTER the source filter so stray/spoofed datagrams cannot
        # pollute RTCP loss/jitter or latch a wrong SSRC
        if self.rtcp is not None:
            self._rx_stats.on_packet(data, rtime)
        self.stream_in.rtp_received(data, address, rtime)

    # -- tx ------------------------------------------------------------------
    def _send_pkt(self, pkt: bytes) -> None:
        if self.params.rtp_target is not None:
            self.udp.send_to(pkt, self.params.rtp_target)

    def soundout(self, chunk: Union[AudioChunk, ASMarkerGeneric]) -> None:
        if self.firstframe and isinstance(chunk, AudioChunk):
            log.debug("first frame out on %s (%d samples)", self.id,
                      len(chunk.audio))
            self.firstframe = False
        # the native leg sends from C++ (no per-packet Python): refresh its
        # destination per chunk in case rtp_target changed since last
        if (self.params.rtp_target is not None
                and hasattr(self.writer, "set_dest")
                and self._writer_dest != self.params.rtp_target):
            self.writer.set_dest(self.params.rtp_target)
            self._writer_dest = self.params.rtp_target
        if (self.rtcp is not None and self.params.rtp_target is not None
                and self.rtcp.target is None):
            self.rtcp.target = (self.params.rtp_target[0],
                                self.params.rtp_target[1] + 1)
        self.writer.soundout(chunk)

    # -- control -------------------------------------------------------------
    def connect(self, ain: AudioInput) -> None:
        self.stream_in.stream_connect(ain)

    def update(self, params: RTPParams) -> None:
        """Re-INVITE: retarget and swap the writer if ptime/codec changed."""
        old = self.params
        self.params = params
        if (params.out_ptime != old.out_ptime or params.codec is not old.codec):
            self.writer.end()
            self.writer = self._make_writer(params)
            self.writer.start()
        elif params.rtp_target is not None and hasattr(self.writer, "set_dest"):
            self.writer.set_dest(params.rtp_target)  # native leg retarget
            self._writer_dest = params.rtp_target
        if self.rtcp is not None and params.rtp_target is not None:
            self.rtcp.target = (params.rtp_target[0], params.rtp_target[1] + 1)
        self.stream_in.stream_update()

    @property
    def local_addr(self) -> Tuple[str, int]:
        return self.udp.laddr

    def shutdown(self) -> None:
        if self.rtcp is not None:
            self.rtcp.close()
        self.writer.end()
        self.udp.shutdown()
        self.stream_in.release()
        self.allocator.release(self.udp.laddr[1])
