"""SIP message model: parse and serialize requests/responses (RFC 3261).

Capability parity: the reference rides on the external sippy b2bua's message
layer (``SIP/InfernSIP.py:31-35``).  This framework ships its own compact
signaling plane, so the SIP surface is self-contained.
"""

from __future__ import annotations

import re
import secrets
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

SIP_VERSION = "SIP/2.0"

_COMPACT = {"v": "via", "f": "from", "t": "to", "i": "call-id", "m": "contact",
            "l": "content-length", "c": "content-type", "s": "subject"}


def gen_branch() -> str:
    return "z9hG4bK" + secrets.token_hex(8)


def gen_tag() -> str:
    return secrets.token_hex(6)


def gen_call_id(host: str = "") -> str:
    cid = secrets.token_hex(12)
    return f"{cid}@{host}" if host else cid


@dataclass
class SipURI:
    user: str = ""
    host: str = ""
    port: Optional[int] = None
    params: Dict[str, Optional[str]] = field(default_factory=dict)

    @classmethod
    def parse(cls, s: str) -> "SipURI":
        s = s.strip()
        if s.startswith("<") and s.endswith(">"):
            s = s[1:-1]
        if s.startswith("sip:"):
            s = s[4:]
        elif s.startswith("sips:"):
            s = s[5:]
        params: Dict[str, Optional[str]] = {}
        if ";" in s:
            s, _, ptail = s.partition(";")
            for p in ptail.split(";"):
                k, _, v = p.partition("=")
                params[k] = v or None
        user, _, hostport = s.rpartition("@")
        host, _, port = hostport.partition(":")
        return cls(user=user, host=host, port=int(port) if port else None,
                   params=params)

    def __str__(self) -> str:
        out = "sip:"
        if self.user:
            out += f"{self.user}@"
        out += self.host
        if self.port:
            out += f":{self.port}"
        for k, v in self.params.items():
            out += f";{k}" if v is None else f";{k}={v}"
        return out

    @property
    def addr(self) -> Tuple[str, int]:
        return (self.host, self.port or 5060)


@dataclass
class NameAddr:
    """display-name <uri>;params (From/To/Contact header value)."""

    uri: SipURI
    display: str = ""
    params: Dict[str, str] = field(default_factory=dict)

    @classmethod
    def parse(cls, s: str) -> "NameAddr":
        s = s.strip()
        display = ""
        m = re.match(r'^(?:"([^"]*)"|([^<]*?))\s*<([^>]+)>(.*)$', s)
        params: Dict[str, str] = {}
        if m:
            display = (m.group(1) or m.group(2) or "").strip()
            uri_s = m.group(3)
            tail = m.group(4)
            for p in tail.split(";"):
                if not p.strip():
                    continue
                k, _, v = p.partition("=")
                params[k.strip()] = v.strip()
        else:
            uri_s, _, tail = s.partition(";")
            for p in tail.split(";"):
                if not p.strip():
                    continue
                k, _, v = p.partition("=")
                params[k.strip()] = v.strip()
        return cls(uri=SipURI.parse(uri_s), display=display, params=params)

    def __str__(self) -> str:
        out = f'"{self.display}" ' if self.display else ""
        out += f"<{self.uri}>"
        for k, v in self.params.items():
            out += f";{k}={v}" if v else f";{k}"
        return out

    @property
    def tag(self) -> Optional[str]:
        return self.params.get("tag")

    def with_tag(self, tag: str) -> "NameAddr":
        na = NameAddr(self.uri, self.display, dict(self.params))
        na.params["tag"] = tag
        return na


class SipMessage:
    """One SIP request or response."""

    def __init__(self):
        self.method: Optional[str] = None
        self.ruri: Optional[SipURI] = None
        self.code: Optional[int] = None
        self.reason: Optional[str] = None
        self.headers: List[Tuple[str, str]] = []  # (lowercase name, value)
        self.body: bytes = b""

    # -- accessors -----------------------------------------------------------
    @property
    def is_request(self) -> bool:
        return self.method is not None

    def get(self, name: str, default: Optional[str] = None) -> Optional[str]:
        name = name.lower()
        for k, v in self.headers:
            if k == name:
                return v
        return default

    def get_all(self, name: str) -> List[str]:
        name = name.lower()
        return [v for k, v in self.headers if k == name]

    def set(self, name: str, value: str) -> None:
        name_l = name.lower()
        for i, (k, _) in enumerate(self.headers):
            if k == name_l:
                self.headers[i] = (name_l, value)
                return
        self.headers.append((name_l, value))

    def add(self, name: str, value: str) -> None:
        self.headers.append((name.lower(), value))

    def remove(self, name: str) -> None:
        name = name.lower()
        self.headers = [(k, v) for k, v in self.headers if k != name]

    @property
    def call_id(self) -> str:
        return self.get("call-id", "")

    @property
    def cseq(self) -> Tuple[int, str]:
        v = self.get("cseq", "0 UNKNOWN").split()
        return int(v[0]), v[1] if len(v) > 1 else ""

    @property
    def from_na(self) -> NameAddr:
        return NameAddr.parse(self.get("from", ""))

    @property
    def to_na(self) -> NameAddr:
        return NameAddr.parse(self.get("to", ""))

    @property
    def via_branch(self) -> Optional[str]:
        via = self.get("via", "")
        m = re.search(r"branch=([^;,\s]+)", via)
        return m.group(1) if m else None

    # -- construction ----------------------------------------------------------
    @classmethod
    def request(cls, method: str, ruri: SipURI) -> "SipMessage":
        m = cls()
        m.method = method
        m.ruri = ruri
        return m

    @classmethod
    def response_to(cls, req: "SipMessage", code: int, reason: str,
                    to_tag: Optional[str] = None) -> "SipMessage":
        r = cls()
        r.code, r.reason = code, reason
        for name in ("via", "from", "call-id", "cseq"):
            for v in req.get_all(name):
                r.add(name, v)
        to = req.to_na
        if to_tag and not to.tag:
            to = to.with_tag(to_tag)
        r.add("to", str(to))
        r.set("content-length", "0")
        return r

    # -- wire format -------------------------------------------------------------
    @classmethod
    def parse(cls, data: bytes) -> "SipMessage":
        head, _, body = data.partition(b"\r\n\r\n")
        if not _ and b"\n\n" in data:
            head, _, body = data.partition(b"\n\n")
        lines = head.decode("utf-8", "replace").replace("\r\n", "\n").split("\n")
        # unfold continuations
        unfolded: List[str] = []
        for ln in lines:
            if ln[:1] in (" ", "\t") and unfolded:
                unfolded[-1] += " " + ln.strip()
            else:
                unfolded.append(ln)
        start = unfolded[0]
        msg = cls()
        if start.startswith(SIP_VERSION):
            parts = start.split(" ", 2)
            msg.code = int(parts[1])
            msg.reason = parts[2] if len(parts) > 2 else ""
        else:
            method, uri, ver = start.split(" ", 2)
            if not ver.startswith("SIP/"):
                raise ValueError(f"bad request line: {start!r}")
            msg.method = method
            msg.ruri = SipURI.parse(uri)
        for ln in unfolded[1:]:
            if not ln.strip():
                continue
            name, _, value = ln.partition(":")
            name = name.strip().lower()
            name = _COMPACT.get(name, name)
            msg.headers.append((name, value.strip()))
        clen = msg.get("content-length")
        if clen is not None:
            body = body[: int(clen)]
        msg.body = body
        return msg

    def build(self) -> bytes:
        if self.is_request:
            start = f"{self.method} {self.ruri} {SIP_VERSION}"
        else:
            start = f"{SIP_VERSION} {self.code} {self.reason}"
        self.set("content-length", str(len(self.body)))
        canon = {"call-id": "Call-ID", "cseq": "CSeq", "www-authenticate":
                 "WWW-Authenticate", "proxy-authenticate": "Proxy-Authenticate"}
        out = [start]
        for k, v in self.headers:
            name = canon.get(k, k.title())
            out.append(f"{name}: {v}")
        return ("\r\n".join(out) + "\r\n\r\n").encode() + self.body
