"""Asyncio SIP stack: UDP transport, transactions, dialogs.

Capability parity: stands in for the external sippy b2bua's
``SipTransactionManager`` / ``Udp_server`` / event loop that the reference
builds on (``SIP/InfernSIP.py:31-35``, ``Cluster/InfernSIPActor.py:16-27``).
The signaling plane runs on one asyncio loop (the reference marshals all SIP
mutation onto its ED2 thread for the same single-writer discipline,
``Cluster/InfernSIPActor.py:30-58``).

Scope: UDP + TCP (RFC 3261 18 stream framing; ``enable_tcp=True`` listens,
``connect_tcp`` dials out), INVITE/ACK/BYE/CANCEL/REGISTER/OPTIONS/UPDATE/
PRACK, RFC 3261 timers A/B (simplified), retransmission absorption by
branch (suppressed on streams), digest auth on the client side.
"""

from __future__ import annotations

import asyncio
import hashlib
import re
import secrets
import time
from typing import Callable, Dict, Optional, Tuple

from ..utils.logging import get_logger
from .message import NameAddr, SipMessage, SipURI, gen_branch, gen_call_id

log = get_logger("sip.stack")

T1 = 0.5
INVITE_TIMEOUT = 32.0


# -- digest auth -----------------------------------------------------------------

def digest_response(challenge: str, method: str, uri: str, user: str,
                    password: str) -> str:
    """Build an Authorization header value for a Digest challenge."""
    vals = {k: (a or b) for k, a, b in
            re.findall(r'(\w+)=(?:"([^"]*)"|([^",\s]+))', challenge)}
    realm = vals.get("realm", "")
    nonce = vals.get("nonce", "")
    qop = vals.get("qop", "")
    algorithm = vals.get("algorithm", "MD5")

    def h(s: str) -> str:
        return hashlib.md5(s.encode()).hexdigest()

    ha1 = h(f"{user}:{realm}:{password}")
    ha2 = h(f"{method}:{uri}")
    if qop and "auth" in qop:
        nc = "00000001"
        cnonce = secrets.token_hex(8)
        resp = h(f"{ha1}:{nonce}:{nc}:{cnonce}:auth:{ha2}")
        return (f'Digest username="{user}", realm="{realm}", nonce="{nonce}", '
                f'uri="{uri}", response="{resp}", qop=auth, nc={nc}, '
                f'cnonce="{cnonce}", algorithm={algorithm}')
    resp = h(f"{ha1}:{nonce}:{ha2}")
    return (f'Digest username="{user}", realm="{realm}", nonce="{nonce}", '
            f'uri="{uri}", response="{resp}", algorithm={algorithm}')


# -- transactions ------------------------------------------------------------------


class _ClientTxn:
    def __init__(self, msg: SipMessage, addr, on_provisional=None):
        self.msg = msg
        self.addr = addr
        self.branch = msg.via_branch
        self.final: asyncio.Future = asyncio.get_event_loop().create_future()
        self.on_provisional = on_provisional


class _SipTcpConn(asyncio.Protocol):
    """One SIP-over-TCP stream: Content-Length framing into the stack's
    request/response dispatch (RFC 3261 18; beyond the reference's
    UDP-only sippy usage -- 'matching' the sippy capability surface)."""

    def __init__(self, stack: "SIPStack"):
        self.stack = stack
        self.buf = b""
        self.peer: Optional[Tuple[str, int]] = None
        self.transport = None

    def connection_made(self, transport) -> None:
        self.transport = transport
        self.peer = transport.get_extra_info("peername")[:2]
        self.stack._tcp_conns[self.peer] = self

    def connection_lost(self, exc) -> None:
        if self.peer is not None:
            self.stack._tcp_conns.pop(self.peer, None)

    def data_received(self, data: bytes) -> None:
        self.buf += data
        while True:
            head_end = self.buf.find(b"\r\n\r\n")
            if head_end < 0:
                if len(self.buf) > 1 << 20:
                    self.transport.close()  # oversized headers
                return
            head = self.buf[:head_end].lower()
            clen = 0
            for line in head.split(b"\r\n"):
                if line.startswith(b"content-length:") or line.startswith(b"l:"):
                    try:
                        clen = int(line.split(b":", 1)[1].strip())
                    except ValueError:
                        pass
            total = head_end + 4 + clen
            if len(self.buf) < total:
                return
            frame, self.buf = self.buf[:total], self.buf[total:]
            try:
                msg = SipMessage.parse(frame)
            except Exception as e:
                log.debug("unparseable SIP/TCP from %s: %s", self.peer, e)
                continue
            if msg.is_request:
                self.stack._handle_request(msg, self.peer)
            else:
                self.stack._handle_response(msg, self.peer)

    def send(self, data: bytes) -> None:
        self.transport.write(data)


class SIPStack(asyncio.DatagramProtocol):
    """One UDP socket (+ optional TCP listener) + transaction tables +
    dialog routing."""

    def __init__(self, bind: Tuple[str, int] = ("127.0.0.1", 0),
                 enable_tcp: bool = False):
        self._bind = bind
        self.transport: Optional[asyncio.DatagramTransport] = None
        self.local_addr: Tuple[str, int] = bind
        self._client_txns: Dict[str, _ClientTxn] = {}  # branch -> txn
        self._server_last: Dict[str, Tuple[bytes, float]] = {}  # branch+method
        self._server_last_sweep = time.monotonic()
        #: app hook: called with (SipMessage, source_addr) for new INVITEs
        self.on_invite: Optional[Callable] = None
        #: dialog routing: dialog_id -> handler(msg, addr)
        self.dialogs: Dict[Tuple[str, str, str], Callable] = {}
        self._loop = None
        self._enable_tcp = enable_tcp
        self._tcp_server = None
        self._tcp_conns: Dict[Tuple[str, int], _SipTcpConn] = {}

    # -- lifecycle ------------------------------------------------------------
    async def start(self) -> None:
        self._loop = asyncio.get_running_loop()
        self.transport, _ = await self._loop.create_datagram_endpoint(
            lambda: self, local_addr=self._bind)
        self.local_addr = self.transport.get_extra_info("sockname")[:2]
        if self._enable_tcp:
            self._tcp_server = await self._loop.create_server(
                lambda: _SipTcpConn(self), self.local_addr[0],
                self.local_addr[1])

    async def connect_tcp(self, addr: Tuple[str, int]) -> None:
        """Open (or reuse) an outbound SIP/TCP connection to ``addr``;
        subsequent sends to that address ride the stream."""
        if addr in self._tcp_conns:
            return
        if self._loop is None:
            self._loop = asyncio.get_running_loop()
        await self._loop.create_connection(
            lambda: _SipTcpConn(self), addr[0], addr[1])

    def _send_to(self, data: bytes, addr) -> None:
        """Transport-routing send: TCP stream when one exists for the
        address, UDP datagram otherwise."""
        conn = self._tcp_conns.get(tuple(addr[:2]))
        if conn is not None:
            conn.send(data)
        else:
            self.transport.sendto(data, addr)

    def is_tcp(self, addr) -> bool:
        return tuple(addr[:2]) in self._tcp_conns

    def close(self) -> None:
        if self.transport:
            self.transport.close()
        if self._tcp_server is not None:
            self._tcp_server.close()
        for conn in list(self._tcp_conns.values()):
            try:
                conn.transport.close()
            except Exception:
                pass

    # -- datagram interface -----------------------------------------------------
    def datagram_received(self, data: bytes, addr) -> None:
        try:
            msg = SipMessage.parse(data)
        except Exception as e:
            log.debug("unparseable SIP from %s: %s", addr, e)
            return
        if msg.is_request:
            self._handle_request(msg, addr)
        else:
            self._handle_response(msg, addr)

    # -- requests ------------------------------------------------------------------
    def _dialog_id(self, msg: SipMessage, as_uas: bool) -> Tuple[str, str, str]:
        f, t = msg.from_na.tag or "", msg.to_na.tag or ""
        local, remote = (t, f) if as_uas else (f, t)
        return (msg.call_id, local, remote)

    def _handle_request(self, msg: SipMessage, addr) -> None:
        branch_key = f"{msg.via_branch}:{msg.method}"
        if msg.method != "ACK":
            prev = self._server_last.get(branch_key)
            if prev is not None and time.monotonic() - prev[1] < 32.0:
                self._send_to(prev[0], addr)  # retransmission
                return
        # in-dialog?
        did = self._dialog_id(msg, as_uas=True)
        handler = self.dialogs.get(did)
        if handler is None and msg.to_na.tag:
            # maybe stored with empty remote tag (ACK for initial INVITE)
            handler = self.dialogs.get((msg.call_id, msg.to_na.tag or "", ""))
        if handler is not None:
            handler(msg, addr)
            return
        if msg.method == "INVITE" and self.on_invite is not None:
            self.on_invite(msg, addr)
            return
        if msg.method == "OPTIONS":
            self.send_response(msg, addr, 200, "OK")
            return
        if msg.method == "ACK":
            return
        self.send_response(msg, addr, 481, "Call Leg/Transaction Does Not Exist")

    def _handle_response(self, msg: SipMessage, addr) -> None:
        txn = self._client_txns.get(msg.via_branch or "")
        if txn is None:
            return
        code = msg.code or 0
        if code < 200:
            if txn.on_provisional:
                txn.on_provisional(msg)
            return
        if not txn.final.done():
            txn.final.set_result(msg)
        self._client_txns.pop(txn.branch, None)

    # -- sending ---------------------------------------------------------------------
    def send_response(self, req: SipMessage, addr, code: int, reason: str,
                      to_tag: Optional[str] = None, body: bytes = b"",
                      content_type: Optional[str] = None,
                      extra: Optional[Dict[str, str]] = None) -> SipMessage:
        resp = SipMessage.response_to(req, code, reason, to_tag=to_tag)
        if body:
            resp.body = body
            resp.set("content-type", content_type or "application/sdp")
        if extra:
            for k, v in extra.items():
                resp.set(k, v)
        data = resp.build()
        now = time.monotonic()
        self._server_last[f"{req.via_branch}:{req.method}"] = (data, now)
        # evict entries past the 32 s retransmission window (amortized
        # sweep; otherwise a long-running daemon retains every response
        # it ever sent)
        if now - self._server_last_sweep > 8.0:
            self._server_last_sweep = now
            stale = [k for k, (_, t) in self._server_last.items()
                     if now - t >= 32.0]
            for k in stale:
                del self._server_last[k]
        self._send_to(data, addr)
        return resp

    async def send_request(self, msg: SipMessage, addr,
                           on_provisional=None,
                           timeout: float = INVITE_TIMEOUT) -> SipMessage:
        """Send with retransmission until a final response (or timeout)."""
        if msg.get("via") is None:
            branch = gen_branch()
            msg.add("via", f"SIP/2.0/UDP {self.local_addr[0]}:{self.local_addr[1]}"
                           f";branch={branch};rport")
        txn = _ClientTxn(msg, addr, on_provisional)
        self._client_txns[txn.branch] = txn
        data = msg.build()
        interval = T1
        deadline = time.monotonic() + timeout
        self._send_to(data, addr)
        while True:
            try:
                return await asyncio.wait_for(
                    asyncio.shield(txn.final),
                    timeout=min(interval, max(0.01, deadline - time.monotonic())),
                )
            except asyncio.TimeoutError:
                if time.monotonic() >= deadline:
                    self._client_txns.pop(txn.branch, None)
                    raise TimeoutError(f"no response to {msg.method}")
                if not self.is_tcp(addr):  # no retransmission on streams
                    self._send_to(data, addr)
                interval = min(interval * 2, 4.0)

    def send_ack(self, invite: SipMessage, final: SipMessage, addr) -> None:
        """ACK for a 2xx (new transaction, same Call-ID/CSeq number)."""
        ack = SipMessage.request("ACK", invite.ruri)
        branch = gen_branch()
        ack.add("via", f"SIP/2.0/UDP {self.local_addr[0]}:{self.local_addr[1]}"
                       f";branch={branch};rport")
        ack.add("from", final.get("from"))
        ack.add("to", final.get("to"))
        ack.add("call-id", final.call_id)
        ack.add("cseq", f"{final.cseq[0]} ACK")
        ack.set("max-forwards", "70")
        self._send_to(ack.build(), addr)

    # -- request construction helper -----------------------------------------------
    def make_request(self, method: str, ruri: SipURI, from_na: NameAddr,
                     to_na: NameAddr, call_id: Optional[str] = None,
                     cseq: int = 1, contact: bool = True) -> SipMessage:
        msg = SipMessage.request(method, ruri)
        branch = gen_branch()
        msg.add("via", f"SIP/2.0/UDP {self.local_addr[0]}:{self.local_addr[1]}"
                       f";branch={branch};rport")
        msg.add("max-forwards", "70")
        msg.add("from", str(from_na))
        msg.add("to", str(to_na))
        msg.add("call-id", call_id or gen_call_id(self.local_addr[0]))
        msg.add("cseq", f"{cseq} {method}")
        if contact:
            msg.add("contact",
                    f"<sip:{self.local_addr[0]}:{self.local_addr[1]}>")
        return msg
