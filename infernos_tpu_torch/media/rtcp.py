"""RTCP (RFC 3550): sender/receiver reports, SDES, BYE.

Beyond the reference (no RTCP anywhere in its tree): each call leg binds
RTP-port+1, emits an SR (when we sent since the last tick) or RR every
~5 s with loss/jitter receiver blocks, parses the peer's reports into the
metrics registry, and sends BYE at teardown.  Interarrival jitter and loss
come from the ingest stream's per-arrival stats (RFC 3550 A.8).
"""

from __future__ import annotations

import random
import struct
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..utils.logging import get_logger
from ..utils.metrics import metrics

log = get_logger("media.rtcp")

SR, RR, SDES, BYE = 200, 201, 202, 203
NTP_EPOCH_DELTA = 2208988800  # 1900 -> 1970


def _ntp_now() -> Tuple[int, int]:
    t = time.time() + NTP_EPOCH_DELTA
    sec = int(t)
    frac = int((t - sec) * (1 << 32)) & 0xFFFFFFFF
    return sec & 0xFFFFFFFF, frac


class ReportBlock:
    __slots__ = ("ssrc", "fraction_lost", "cum_lost", "ext_high_seq",
                 "jitter", "lsr", "dlsr")

    def __init__(self, ssrc, fraction_lost, cum_lost, ext_high_seq, jitter,
                 lsr=0, dlsr=0):
        self.ssrc = ssrc
        self.fraction_lost = fraction_lost
        self.cum_lost = cum_lost
        self.ext_high_seq = ext_high_seq
        self.jitter = jitter
        self.lsr = lsr
        self.dlsr = dlsr

    def pack(self) -> bytes:
        cum = max(-(1 << 23), min(self.cum_lost, (1 << 23) - 1)) & 0xFFFFFF
        return struct.pack("!I", self.ssrc) + \
            bytes([self.fraction_lost & 0xFF]) + cum.to_bytes(3, "big") + \
            struct.pack("!IIII", self.ext_high_seq & 0xFFFFFFFF,
                        int(self.jitter) & 0xFFFFFFFF, self.lsr, self.dlsr)

    @classmethod
    def unpack(cls, b: bytes) -> "ReportBlock":
        ssrc, = struct.unpack("!I", b[:4])
        fraction = b[4]
        cum = int.from_bytes(b[5:8], "big")
        if cum & 0x800000:
            cum -= 1 << 24
        high, jit, lsr, dlsr = struct.unpack("!IIII", b[8:24])
        return cls(ssrc, fraction, cum, high, jit, lsr, dlsr)


def _hdr(pt: int, count: int, length_words: int) -> bytes:
    return bytes([0x80 | (count & 0x1F), pt]) + struct.pack("!H", length_words)


def build_sr(ssrc: int, rtp_ts: int, pkt_count: int, octet_count: int,
             reports: List[ReportBlock] = ()) -> bytes:
    ntp_s, ntp_f = _ntp_now()
    body = struct.pack("!IIIIII", ssrc, ntp_s, ntp_f, rtp_ts & 0xFFFFFFFF,
                       pkt_count & 0xFFFFFFFF, octet_count & 0xFFFFFFFF)
    body += b"".join(r.pack() for r in reports)
    return _hdr(SR, len(reports), len(body) // 4) + body


def build_rr(ssrc: int, reports: List[ReportBlock] = ()) -> bytes:
    body = struct.pack("!I", ssrc) + b"".join(r.pack() for r in reports)
    return _hdr(RR, len(reports), len(body) // 4) + body


def build_sdes(ssrc: int, cname: str) -> bytes:
    item = bytes([1, len(cname)]) + cname.encode()
    chunk = struct.pack("!I", ssrc) + item + b"\x00"
    while len(chunk) % 4:
        chunk += b"\x00"
    return _hdr(SDES, 1, len(chunk) // 4) + chunk


def build_bye(ssrc: int) -> bytes:
    return _hdr(BYE, 1, 1) + struct.pack("!I", ssrc)


class RTCPRecord:
    __slots__ = ("pt", "ssrc", "ntp", "rtp_ts", "pkt_count", "octet_count",
                 "reports", "cname")

    def __init__(self, pt, ssrc, ntp=None, rtp_ts=0, pkt_count=0,
                 octet_count=0, reports=(), cname=None):
        self.pt = pt
        self.ssrc = ssrc
        self.ntp = ntp
        self.rtp_ts = rtp_ts
        self.pkt_count = pkt_count
        self.octet_count = octet_count
        self.reports = list(reports)
        self.cname = cname


def parse(data: bytes) -> List[RTCPRecord]:
    """Parse a (possibly compound) RTCP datagram."""
    out: List[RTCPRecord] = []
    off = 0
    while off + 4 <= len(data):
        b0, pt, length = data[off], data[off + 1], \
            struct.unpack("!H", data[off + 2:off + 4])[0]
        if (b0 >> 6) != 2:
            break
        count = b0 & 0x1F
        end = off + 4 + 4 * length
        if end > len(data):
            break
        body = data[off + 4:end]
        if pt == SR and len(body) >= 24:
            ssrc, ntp_s, ntp_f, rtp_ts, pc, oc = struct.unpack("!IIIIII",
                                                               body[:24])
            reports = [ReportBlock.unpack(body[24 + i * 24:48 + i * 24])
                       for i in range(count)
                       if len(body) >= 48 + i * 24 - 24 + 24]
            out.append(RTCPRecord(SR, ssrc, ntp=(ntp_s, ntp_f), rtp_ts=rtp_ts,
                                  pkt_count=pc, octet_count=oc,
                                  reports=reports))
        elif pt == RR and len(body) >= 4:
            ssrc, = struct.unpack("!I", body[:4])
            reports = [ReportBlock.unpack(body[4 + i * 24:28 + i * 24])
                       for i in range(count) if len(body) >= 28 + i * 24]
            out.append(RTCPRecord(RR, ssrc, reports=reports))
        elif pt == SDES and len(body) >= 8:
            ssrc, = struct.unpack("!I", body[:4])
            cname = None
            if body[4] == 1:
                ln = body[5]
                cname = body[6:6 + ln].decode("utf-8", "replace")
            out.append(RTCPRecord(SDES, ssrc, cname=cname))
        elif pt == BYE and len(body) >= 4:
            ssrc, = struct.unpack("!I", body[:4])
            out.append(RTCPRecord(BYE, ssrc))
        off = end
    return out


class RxStats:
    """Per-stream receiver statistics (RFC 3550 A.8), fed per RTP arrival."""

    def __init__(self, clock_rate: int = 8000):
        self.clock_rate = clock_rate
        self.ssrc: Optional[int] = None
        self.base_seq: Optional[int] = None
        self.max_seq = 0
        self.cycles = 0
        self.received = 0
        self.jitter = 0.0
        self._last_transit: Optional[float] = None
        self._exp_prior = 0
        self._rx_prior = 0
        self._lock = threading.Lock()

    def on_packet(self, data: bytes, rtime: float) -> None:
        if len(data) < 12:
            return
        seq = (data[2] << 8) | data[3]
        ts = struct.unpack("!I", data[4:8])[0]
        ssrc = struct.unpack("!I", data[8:12])[0]
        with self._lock:
            if self.ssrc is None:
                self.ssrc = ssrc  # latch first source
            elif ssrc != self.ssrc:
                # mid-stream SSRC change (peer restart): reset stats so the
                # new stream's seq/jitter baseline is clean
                self.ssrc = ssrc
                self.base_seq = None
                self.cycles = 0
                self.received = 0
                self.jitter = 0.0
                self._last_transit = None
                self._exp_prior = 0
                self._rx_prior = 0
            if self.base_seq is None:
                self.base_seq = seq
                self.max_seq = seq
            elif seq < self.max_seq and self.max_seq - seq > 0x8000:
                self.cycles += 1 << 16
            if seq > self.max_seq or self.max_seq - seq > 0x8000:
                self.max_seq = seq
            self.received += 1
            transit = rtime * self.clock_rate - ts
            if self._last_transit is not None:
                d = abs(transit - self._last_transit)
                self.jitter += (d - self.jitter) / 16.0
            self._last_transit = transit

    def report_block(self) -> Optional[ReportBlock]:
        with self._lock:
            if self.ssrc is None or self.base_seq is None:
                return None
            ext_high = self.cycles + self.max_seq
            expected = ext_high - self.base_seq + 1
            lost = max(0, expected - self.received)
            exp_int = expected - self._exp_prior
            rx_int = self.received - self._rx_prior
            self._exp_prior = expected
            self._rx_prior = self.received
            lost_int = max(0, exp_int - rx_int)
            fraction = (lost_int << 8) // exp_int if exp_int > 0 else 0
            return ReportBlock(self.ssrc, min(fraction, 255), lost,
                               ext_high, self.jitter)


class RTCPSession:
    """One leg's RTCP endpoint: periodic SR/RR + SDES, BYE at close.

    ``get_tx_stats``: () -> (pkt_count, octet_count, last_rtp_ts) from the
    pacer.  ``rx_stats``: the ingest-side :class:`RxStats`.
    """

    INTERVAL_S = 5.0

    def __init__(self, udp, rx_stats: RxStats,
                 get_tx_stats: Callable[[], Tuple[int, int, int]],
                 ssrc: Optional[int] = None, cname: str = "infernos-tpu"):
        self.udp = udp  # UdpServer bound at rtp_port+1; data_cb -> on_rtcp
        self.rx_stats = rx_stats
        self.get_tx_stats = get_tx_stats
        self.ssrc = ssrc if ssrc is not None else random.getrandbits(32)
        self.cname = cname
        self.target: Optional[Tuple[str, int]] = None
        self.remote: Dict[str, float] = {}  # last parsed peer stats
        self._last_tx_pkts = 0
        self._next_at = time.monotonic() + random.uniform(2.0, 3.0)
        self._closed = False
        _ticker.add(self)

    # -- inbound ---------------------------------------------------------------
    def on_rtcp(self, data: bytes, addr, rtime: float) -> None:
        for rec in parse(data):
            if rec.pt in (SR, RR):
                for rb in rec.reports:
                    self.remote = {
                        "fraction_lost": rb.fraction_lost / 256.0,
                        "cum_lost": rb.cum_lost,
                        "jitter_ms": rb.jitter / 8.0,  # 8 kHz units
                    }
                    metrics.observe("rtcp.peer_jitter_ms", rb.jitter / 8.0)
                    metrics.observe("rtcp.peer_fraction_lost",
                                    rb.fraction_lost / 256.0)

    # -- outbound --------------------------------------------------------------
    def tick(self, now: float) -> None:
        if self._closed or self.target is None or now < self._next_at:
            return
        self._next_at = now + self.INTERVAL_S + random.uniform(-0.5, 0.5)
        try:
            reports = []
            rb = self.rx_stats.report_block()
            if rb is not None:
                reports.append(rb)
            pkts, octets, rtp_ts = self.get_tx_stats()
            if pkts > self._last_tx_pkts:
                pkt = build_sr(self.ssrc, rtp_ts, pkts, octets, reports)
            else:
                pkt = build_rr(self.ssrc, reports)
            self._last_tx_pkts = pkts
            self.udp.send_to(pkt + build_sdes(self.ssrc, self.cname),
                             self.target)
        except Exception:
            log.exception("rtcp tick failed")

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        _ticker.remove(self)
        if self.target is not None:
            try:
                self.udp.send_to(build_bye(self.ssrc), self.target)
            except Exception:
                pass
        self.udp.shutdown()


class _Ticker:
    """One thread drives every leg's RTCP cadence."""

    def __init__(self):
        self._sessions: List[RTCPSession] = []
        self._lock = threading.Lock()
        self._thr: Optional[threading.Thread] = None

    def add(self, s: RTCPSession) -> None:
        with self._lock:
            self._sessions.append(s)
            if self._thr is None:
                self._thr = threading.Thread(target=self._loop, daemon=True,
                                             name="rtcp-ticker")
                self._thr.start()

    def remove(self, s: RTCPSession) -> None:
        with self._lock:
            if s in self._sessions:
                self._sessions.remove(s)

    def _loop(self) -> None:
        while True:
            time.sleep(1.0)
            now = time.monotonic()
            with self._lock:
                sessions = list(self._sessions)
            for s in sessions:
                s.tick(now)


_ticker = _Ticker()
