"""SDP parse/build and audio codec negotiation.

Capability parity with the reference's offer/answer handling
(``SIP/InfernUA.py:80-113``): pick the first supported codec from the
offer's audio section (G722 preferred, then PCMU/PCMA --
``SIP/InfernUAS.py:50`` accepts ``(G722Codec, G711Codec)``), read ``ptime``,
and build an answer advertising our RTP address/port/codec.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple, Type

from ..audio.codecs import CODECS
from ..media.endpoint import RTPParams


@dataclass
class SdpMedia:
    mtype: str
    port: int
    proto: str
    formats: List[int]
    attrs: List[Tuple[str, str]] = field(default_factory=list)
    c_addr: Optional[str] = None

    def attr(self, name: str) -> Optional[str]:
        for k, v in self.attrs:
            if k == name:
                return v
        return None


@dataclass
class Sdp:
    origin_addr: str = "127.0.0.1"
    sess_id: int = 0
    sess_ver: int = 0
    c_addr: str = "127.0.0.1"
    media: List[SdpMedia] = field(default_factory=list)

    @classmethod
    def parse(cls, text: str) -> "Sdp":
        sdp = cls()
        cur: Optional[SdpMedia] = None
        for line in text.replace("\r\n", "\n").split("\n"):
            if len(line) < 2 or line[1] != "=":
                continue
            key, val = line[0], line[2:]
            if key == "o":
                parts = val.split()
                if len(parts) >= 6:
                    sdp.sess_id, sdp.sess_ver = int(parts[1]), int(parts[2])
                    sdp.origin_addr = parts[5]
            elif key == "c":
                addr = val.split()[-1]
                if cur is None:
                    sdp.c_addr = addr
                else:
                    cur.c_addr = addr
            elif key == "m":
                parts = val.split()
                cur = SdpMedia(parts[0], int(parts[1]), parts[2],
                               [int(f) for f in parts[3:] if f.isdigit()])
                sdp.media.append(cur)
            elif key == "a" and cur is not None:
                name, _, v = val.partition(":")
                cur.attrs.append((name, v))
        return sdp

    def build(self) -> str:
        lines = [
            "v=0",
            f"o=- {self.sess_id} {self.sess_ver} IN IP4 {self.origin_addr}",
            "s=-",
            f"c=IN IP4 {self.c_addr}",
            "t=0 0",
        ]
        for m in self.media:
            fmts = " ".join(str(f) for f in m.formats)
            lines.append(f"m={m.mtype} {m.port} {m.proto} {fmts}")
            if m.c_addr and m.c_addr != self.c_addr:
                lines.append(f"c=IN IP4 {m.c_addr}")
            for k, v in m.attrs:
                lines.append(f"a={k}:{v}" if v else f"a={k}")
        return "\r\n".join(lines) + "\r\n"


# -- offer/answer ---------------------------------------------------------------

#: negotiation preference order (G.722 wideband first, reference
#: ``InfernUAS.accept_codecs``)
DEFAULT_ACCEPT = tuple(CODECS[pt] for pt in (9, 0, 8))


class SdpNegotiationError(Exception):
    pass


def extract_rtp_params(sdp_text: str, accept=DEFAULT_ACCEPT) -> RTPParams:
    """Offer -> negotiated RTPParams (target addr, codec class, ptime)."""
    sdp = Sdp.parse(sdp_text)
    for codec_cls in accept:
        for m in sdp.media:
            if m.mtype != "audio":
                continue
            if codec_cls.ptype in m.formats:
                addr = m.c_addr or sdp.c_addr
                ptime_s = m.attr("ptime")
                params = RTPParams(rtp_target=(addr, m.port), codec=codec_cls,
                                   out_ptime=int(ptime_s) if ptime_s else 20)
                return params
    raise SdpNegotiationError("no supported audio codec in offer")


def build_sdp(local_addr: Tuple[str, int], codec: Type, ptime: int = 20,
              extra_codecs: Tuple[Type, ...] = ()) -> str:
    """Build an offer/answer advertising our RTP endpoint."""
    now = int(time.time())
    fmts = [codec.ptype] + [c.ptype for c in extra_codecs if c is not codec]
    attrs = [("rtpmap", f"{c.ptype} {c.ename}/{c.crate}")
             for c in (codec, *extra_codecs) if True]
    # dedupe attrs preserving order
    seen = set()
    uattrs = []
    for a in attrs:
        if a[1] not in seen:
            seen.add(a[1])
            uattrs.append(a)
    uattrs.append(("ptime", str(ptime)))
    uattrs.append(("sendrecv", ""))
    sdp = Sdp(
        origin_addr=local_addr[0],
        sess_id=now,
        sess_ver=now,
        c_addr=local_addr[0],
        media=[SdpMedia("audio", local_addr[1], "RTP/AVP", fmts, uattrs)],
    )
    return sdp.build()
