"""SIP user agents: inbound (UAS) and outbound (UAC) call legs.

Capability parity with the reference's UA layer:

- :class:`UAS` -- inbound INVITE with **lazy answer**: sends ``100 Trying``
  immediately, defers the UAS decision until the app calls ``accept()`` /
  ``reject()`` (``SIP/InfernUAS.py:102-117``, ``InfernLazyUAS``); SDP
  negotiation accepts G722+G711 with ptime (``:50,78-84``); re-INVITE swaps
  media params (``SIP/InfernUA.py:101-108``); failure events use
  488/500 semantics (``InfernUASFailure``).
- :class:`UAC` -- outbound INVITE with offer SDP, digest auth retry, event
  bridge to a paired UAS leg (``SIP/InfernUAC.py``).

Both legs expose ``on_disconnect`` and drive media through caller-provided
hooks, keeping signaling/media planes decoupled.
"""

from __future__ import annotations

import asyncio
import random
import uuid as uuid_mod
from typing import Callable, Optional, Tuple

from ..utils.logging import get_logger
from .message import NameAddr, SipMessage, SipURI, gen_tag
from .sdp import DEFAULT_ACCEPT, SdpNegotiationError, build_sdp, extract_rtp_params
from .stack import SIPStack, digest_response

log = get_logger("sip.ua")


class _InDialogMixin:
    """Shared in-dialog machinery: outbound re-INVITE with RFC 3261 glare
    handling (491 Request Pending + role-based retry timers) and a minimal
    RFC 4028 session timer (Session-Expires honor + expiry BYE).

    Both are beyond the reference, which delegates in-dialog handling to
    sippy and never originates re-INVITEs or session refreshes.
    """

    #: RFC 4028 lower bound; tests override for fast expiry
    min_session_expires = 90
    _reinvite_pending = False
    _se_interval: Optional[float] = None
    _se_handle = None
    _is_call_owner = False  # True for the UAC (it generated the Call-ID)

    # subclasses provide: stack, call_id, terminated, _dialog_addr(),
    # _local_na(), _remote_na(), _route_uri(), _next_cseq(), bye()

    async def reinvite(self, rtp_laddr: Tuple[str, int], codec,
                       ptime: int = 20, max_attempts: int = 3):
        """Send an in-dialog re-INVITE with a fresh offer; returns the
        negotiated RTPParams from the answer.  On 491 (glare) retries after
        the RFC 3261 14.1 backoff: 2.1-4 s when we own the Call-ID,
        0-2 s otherwise."""
        if self.terminated:
            raise CallFailed(481, "terminated")
        body = build_sdp(rtp_laddr, codec, ptime).encode()
        for attempt in range(max_attempts):
            msg = self.stack.make_request(
                "INVITE", self._route_uri(), self._local_na(),
                self._remote_na(), call_id=self.call_id,
                cseq=self._next_cseq())
            msg.body = body
            msg.set("content-type", "application/sdp")
            self._reinvite_pending = True
            try:
                final = await self.stack.send_request(
                    msg, self._dialog_addr(), timeout=16.0)
            finally:
                self._reinvite_pending = False
            if final.code == 491:
                self.stack.send_ack(msg, final, self._dialog_addr())
                lo, hi = (2.1, 4.0) if self._is_call_owner else (0.0, 2.0)
                await asyncio.sleep(random.uniform(lo, hi))
                continue
            if final.code != 200:
                self.stack.send_ack(msg, final, self._dialog_addr())
                raise CallFailed(final.code, final.reason or "")
            self.stack.send_ack(msg, final, self._dialog_addr())
            self._touch_session_timer()
            return extract_rtp_params(final.body.decode("utf-8", "replace"),
                                      accept=self.accept_codecs)
        raise CallFailed(491, "glare retries exhausted")

    # -- session timer (RFC 4028 minimal) ---------------------------------------
    def _arm_session_timer(self, interval: float) -> None:
        self._se_interval = max(float(interval), float(self.min_session_expires))
        self._touch_session_timer()

    def _touch_session_timer(self) -> None:
        if self._se_interval is None:
            return
        if self._se_handle is not None:
            self._se_handle.cancel()
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return
        self._se_handle = loop.call_later(self._se_interval,
                                          self._session_expired)

    def _cancel_session_timer(self) -> None:
        if self._se_handle is not None:
            self._se_handle.cancel()
            self._se_handle = None
        self._se_interval = None

    def _session_expired(self) -> None:
        log.warning("session %s expired without refresh; sending BYE",
                    self.call_id)
        self._se_handle = None
        asyncio.ensure_future(self.bye())
        if self.on_disconnect is not None:
            self.on_disconnect()

    # -- UPDATE (RFC 3311) ------------------------------------------------------
    def _handle_update(self, msg: SipMessage, addr) -> None:
        """In-dialog UPDATE: session refresh (no body) or media update
        (SDP offer -> immediate SDP answer in the 200; no ACK leg).
        Beyond the reference (sippy handles UPDATE internally)."""
        self._touch_session_timer()
        if not msg.body:
            extra = {}
            if getattr(self, "session_expires", None):
                extra["session-expires"] = \
                    f"{self.session_expires};refresher=uac"
            self.stack.send_response(msg, addr, 200, "OK", extra=extra)
            return
        try:
            params = extract_rtp_params(msg.body.decode("utf-8", "replace"),
                                        accept=self.accept_codecs)
        except SdpNegotiationError:
            self.stack.send_response(msg, addr, 488, "Not Acceptable Here")
            return
        laddr = None
        if self.on_reinvite is not None:
            laddr = self.on_reinvite(params)
        elif getattr(self, "_media", None) is not None:
            laddr = self._media[0]
        if laddr is None:
            self.stack.send_response(msg, addr, 488, "Not Acceptable Here")
            return
        body = build_sdp(laddr, params.codec, params.out_ptime).encode()
        self.stack.send_response(msg, addr, 200, "OK", body=body)

    async def update(self, rtp_laddr: Optional[Tuple[str, int]] = None,
                     codec=None, ptime: int = 20):
        """Originate an in-dialog UPDATE: refresh (no args) or new offer."""
        if self.terminated:
            raise CallFailed(481, "terminated")
        msg = self.stack.make_request(
            "UPDATE", self._route_uri(), self._local_na(),
            self._remote_na(), call_id=self.call_id, cseq=self._next_cseq())
        if rtp_laddr is not None:
            msg.body = build_sdp(rtp_laddr, codec, ptime).encode()
            msg.set("content-type", "application/sdp")
        final = await self.stack.send_request(msg, self._dialog_addr(),
                                              timeout=8.0)
        if final.code != 200:
            raise CallFailed(final.code, final.reason or "")
        self._touch_session_timer()
        if final.body:
            return extract_rtp_params(final.body.decode("utf-8", "replace"),
                                      accept=self.accept_codecs)
        return None


class SipSessInfo:
    """Call metadata exposed to apps (reference ``SIP/SipSessInfo.py``)."""

    def __init__(self, call_id: str, from_name: str, from_number: str):
        self.call_id = call_id
        self.from_name = from_name
        self.from_number = from_number


class UAS(_InDialogMixin):
    """One inbound call leg (server side of the initial INVITE)."""

    def __init__(self, stack: SIPStack, invite: SipMessage, addr,
                 accept_codecs=DEFAULT_ACCEPT):
        self.id = uuid_mod.uuid4()
        self.stack = stack
        self.invite = invite
        self.addr = addr
        self.accept_codecs = accept_codecs
        self.local_tag = gen_tag()
        self.remote_tag = invite.from_na.tag or ""
        self.call_id = invite.call_id
        self.answered = False
        self.terminated = False
        self.on_disconnect: Optional[Callable[[], None]] = None
        self.on_reinvite: Optional[Callable[[object], Optional[Tuple[str, int]]]] = None
        self._remote_cseq = invite.cseq[0]
        self._cseq = 0
        # RFC 4028: caller-requested session interval (clamped; honored in
        # the 200 and enforced by expiry BYE)
        self.session_expires: Optional[int] = None
        se = invite.get("session-expires") or invite.get("x-session-expires")
        if se:
            try:
                iv = int(se.split(";")[0].strip())
                self.session_expires = max(iv, self.min_session_expires)
            except ValueError:
                pass
        # register dialog routes (with and without remote tag for ACK quirks)
        key = (self.call_id, self.local_tag, self.remote_tag)
        stack.dialogs[key] = self._in_dialog
        self._dialog_key = key
        # 100 Trying goes out immediately (reference InfernLazyUAS,
        # SIP/InfernUAS.py:102-103)
        stack.send_response(invite, addr, 100, "Trying")

    # -- metadata ------------------------------------------------------------
    def get_session_info(self) -> SipSessInfo:
        f = self.invite.from_na
        return SipSessInfo(self.call_id, f.display, f.uri.user)

    @property
    def offer_sdp(self) -> str:
        return self.invite.body.decode("utf-8", "replace")

    def negotiate(self):
        """Offer SDP -> RTPParams (raises SdpNegotiationError)."""
        return extract_rtp_params(self.offer_sdp, accept=self.accept_codecs)

    # -- app decisions ----------------------------------------------------------
    def _peer_supports_100rel(self) -> bool:
        for h in ("supported", "require"):
            v = self.invite.get(h) or ""
            if "100rel" in v.lower():
                return True
        return False

    def ring(self, reliable: Optional[bool] = None) -> None:
        """180 Ringing; reliable (RFC 3262) when the caller supports 100rel
        (auto) -- retransmitted until PRACKed."""
        if reliable is None:
            reliable = self._peer_supports_100rel()
        if not reliable:
            self.stack.send_response(self.invite, self.addr, 180, "Ringing",
                                     to_tag=self.local_tag)
            return
        self._rel_rseq = getattr(self, "_rel_rseq", 0) + 1
        rseq = self._rel_rseq
        resp = self.stack.send_response(
            self.invite, self.addr, 180, "Ringing", to_tag=self.local_tag,
            extra={"require": "100rel", "rseq": str(rseq)})
        data = resp.build()
        self._rel_pending = rseq

        async def retransmit():
            interval = 0.5
            for _ in range(7):  # ~64*T1 overall
                await asyncio.sleep(interval)
                if getattr(self, "_rel_pending", None) != rseq \
                        or self.answered or self.terminated:
                    return
                try:
                    self.stack._send_to(data, self.addr)
                except Exception:
                    return
                interval = min(interval * 2, 4.0)

        try:
            self._rel_task = asyncio.ensure_future(retransmit())
        except RuntimeError:
            self._rel_task = None  # no loop (tests); single shot

    def accept(self, rtp_laddr: Tuple[str, int], codec, ptime: int = 20) -> None:
        body = build_sdp(rtp_laddr, codec, ptime).encode()
        extra = {
            "contact": f"<sip:{self.stack.local_addr[0]}:{self.stack.local_addr[1]}>",
        }
        if self.session_expires:
            # we accept the caller's interval; the caller (uac) refreshes
            extra["session-expires"] = f"{self.session_expires};refresher=uac"
            extra["supported"] = "timer"
        self.stack.send_response(
            self.invite, self.addr, 200, "OK", to_tag=self.local_tag,
            body=body, extra=extra)
        self.answered = True
        self._media = (rtp_laddr, codec, ptime)
        if self.session_expires:
            self._arm_session_timer(self.session_expires)

    def reject(self, code: int = 488, reason: str = "Not Acceptable Here") -> None:
        self.stack.send_response(self.invite, self.addr, code, reason,
                                 to_tag=self.local_tag)
        self._teardown()

    # -- in-dialog handling --------------------------------------------------------
    def _in_dialog(self, msg: SipMessage, addr) -> None:
        if msg.method == "ACK":
            return
        if msg.method == "BYE":
            self.stack.send_response(msg, addr, 200, "OK")
            self._teardown(notify=True)
            return
        if msg.method == "INVITE":  # re-INVITE
            if self._reinvite_pending:  # glare: ours is in flight
                self.stack.send_response(msg, addr, 491, "Request Pending")
                return
            self._touch_session_timer()  # a refresh resets RFC 4028 expiry
            try:
                params = extract_rtp_params(msg.body.decode("utf-8", "replace"),
                                            accept=self.accept_codecs)
            except SdpNegotiationError:
                self.stack.send_response(msg, addr, 488, "Not Acceptable Here")
                return
            laddr = None
            if self.on_reinvite is not None:
                laddr = self.on_reinvite(params)
            elif getattr(self, "_media", None) is not None:
                # no app hook: treat as a pure session refresh and re-answer
                # with our current media (RFC 4028 refreshes need no media
                # change and must not fail the dialog)
                laddr = self._media[0]
            if laddr is None:
                self.stack.send_response(msg, addr, 488, "Not Acceptable Here")
                return
            body = build_sdp(laddr, params.codec, params.out_ptime).encode()
            self.stack.send_response(msg, addr, 200, "OK", body=body)
            return
        if msg.method == "CANCEL":
            self.stack.send_response(msg, addr, 200, "OK")
            if not self.answered:
                self.stack.send_response(self.invite, self.addr, 487,
                                         "Request Terminated",
                                         to_tag=self.local_tag)
                self._teardown(notify=True)
            return
        if msg.method == "UPDATE":
            self._handle_update(msg, addr)
            return
        if msg.method == "PRACK":
            # RAck: "<rseq> <cseq> <method>"; a malformed (non-numeric)
            # rseq must get a 400, not raise out of the dialog dispatch
            # and leave the reliable-180 retransmitting (ADVICE r3)
            rack = (msg.get("rack") or "").split()
            try:
                rseq = int(rack[0]) if rack else None
            except ValueError:
                self.stack.send_response(msg, addr, 400, "Bad Request")
                return
            if rseq is not None and getattr(self, "_rel_pending", None) == rseq:
                self._rel_pending = None  # stops the retransmit task
            self.stack.send_response(msg, addr, 200, "OK")
            return
        self.stack.send_response(msg, addr, 501, "Not Implemented")

    # -- in-dialog request plumbing (mixin hooks) -----------------------------
    def _dialog_addr(self):
        return self.addr

    def _local_na(self):
        return self.invite.to_na.with_tag(self.local_tag)

    def _remote_na(self):
        return self.invite.from_na

    def _route_uri(self):
        contact = self.invite.get("contact")
        return NameAddr.parse(contact).uri if contact else self.invite.from_na.uri

    def _next_cseq(self) -> int:
        self._cseq += 1
        return self._cseq

    async def bye(self) -> None:
        """Terminate from our side."""
        if self.terminated:
            return
        bye = self.stack.make_request("BYE", self._route_uri(),
                                      self._local_na(), self._remote_na(),
                                      call_id=self.call_id,
                                      cseq=self._next_cseq(), contact=False)
        try:
            await self.stack.send_request(bye, self.addr, timeout=8.0)
        except TimeoutError:
            pass
        self._teardown()

    def _teardown(self, notify: bool = False) -> None:
        if self.terminated:
            return
        self.terminated = True
        self._cancel_session_timer()
        self.stack.dialogs.pop(self._dialog_key, None)
        if notify and self.on_disconnect is not None:
            self.on_disconnect()


class UAC(_InDialogMixin):
    """One outbound call leg (client side of the INVITE)."""

    _is_call_owner = True  # RFC 3261 14.1: owner backs off 2.1-4 s on glare

    def __init__(self, stack: SIPStack, accept_codecs=DEFAULT_ACCEPT):
        self.id = uuid_mod.uuid4()
        self.stack = stack
        self.accept_codecs = accept_codecs
        self.call_id: Optional[str] = None
        self.local_tag = gen_tag()
        self.remote_tag = ""
        self.invite: Optional[SipMessage] = None
        self.final: Optional[SipMessage] = None
        self.remote_addr = None
        self.terminated = False
        self.connected = False
        self.on_disconnect: Optional[Callable[[], None]] = None
        self.on_reinvite: Optional[Callable[[object], Optional[Tuple[str, int]]]] = None
        self._cseq = 1
        self._dialog_key = None
        self._refresh_task: Optional[asyncio.Task] = None
        self._media = None  # (rtp_laddr, codec, ptime) for session refreshes

    async def invite_call(self, ruri: SipURI, cld: str, rtp_laddr: Tuple[str, int],
                          codec, addr: Tuple[str, int],
                          username: str = "", password: str = "",
                          cli: str = "infernos", ptime: int = 20,
                          session_expires: Optional[int] = None):
        """Send INVITE; returns negotiated RTPParams from the answer.

        ``session_expires``: RFC 4028 interval -- we are the refresher and
        re-INVITE every interval/2; the callee BYEs at expiry if we vanish.
        """
        from_na = NameAddr(SipURI(user=cli, host=self.stack.local_addr[0],
                                  port=self.stack.local_addr[1]))
        from_na = from_na.with_tag(self.local_tag)
        to_na = NameAddr(SipURI(user=cld, host=ruri.host, port=ruri.port))
        msg = self.stack.make_request("INVITE", ruri, from_na, to_na,
                                      cseq=self._cseq)
        msg.body = build_sdp(rtp_laddr, codec, ptime,
                             extra_codecs=tuple(self.accept_codecs)).encode()
        msg.set("content-type", "application/sdp")
        if session_expires:
            msg.set("session-expires", str(int(session_expires)))
            msg.set("supported", "timer, 100rel")
        else:
            msg.set("supported", "100rel")
        self._media = (rtp_laddr, codec, ptime)
        self.call_id = msg.call_id
        self.invite = msg
        self.remote_addr = addr

        inv_cseq = msg.cseq[0]
        pracked = set()

        def on_prov(resp):
            # RFC 3262: acknowledge reliable provisionals with PRACK
            rseq = (resp.get("rseq") or "").strip()
            if not rseq or rseq in pracked:
                return
            pracked.add(rseq)
            self._cseq += 1
            prack = self.stack.make_request(
                "PRACK", ruri, from_na, resp.to_na, call_id=self.call_id,
                cseq=self._cseq, contact=False)
            prack.set("rack", f"{rseq} {inv_cseq} INVITE")

            async def send():
                try:
                    await self.stack.send_request(prack, addr, timeout=4.0)
                except (TimeoutError, Exception):
                    pass

            asyncio.ensure_future(send())

        final = await self.stack.send_request(msg, addr,
                                              on_provisional=on_prov)
        if final.code in (401, 407) and username:
            # digest challenge: retry with credentials
            chal = final.get("www-authenticate") or final.get("proxy-authenticate")
            hdr = "authorization" if final.code == 401 else "proxy-authorization"
            self.stack.send_ack(msg, final, addr)  # ACK the failure
            self._cseq += 1
            msg2 = self.stack.make_request("INVITE", ruri, from_na, to_na,
                                           call_id=self.call_id, cseq=self._cseq)
            msg2.body = msg.body
            msg2.set("content-type", "application/sdp")
            msg2.set(hdr, digest_response(chal, "INVITE", str(ruri),
                                          username, password))
            self.invite = msg2
            final = await self.stack.send_request(msg2, addr)
        self.final = final
        if final.code != 200:
            if final.code >= 300:
                self.stack.send_ack(self.invite, final, addr)
                self.terminated = True
                raise CallFailed(final.code, final.reason or "")
        self.remote_tag = final.to_na.tag or ""
        self.stack.send_ack(self.invite, final, addr)
        self.connected = True
        key = (self.call_id, self.local_tag, self.remote_tag)
        self._dialog_key = key
        self.stack.dialogs[key] = self._in_dialog
        params = extract_rtp_params(final.body.decode("utf-8", "replace"),
                                    accept=self.accept_codecs)
        # RFC 4028: when the answer carries Session-Expires, we refresh at
        # half the interval (we requested refresher=uac semantics)
        se = final.get("session-expires")
        if se:
            try:
                iv = int(se.split(";")[0].strip())
            except ValueError:
                iv = 0
            if iv > 0:
                self._refresh_task = asyncio.ensure_future(
                    self._refresh_loop(iv))
        return params

    async def _refresh_loop(self, interval: int) -> None:
        while not self.terminated:
            await asyncio.sleep(interval / 2.0)
            if self.terminated:
                return
            try:
                laddr, codec, ptime = self._media
                await self.reinvite(laddr, codec, ptime)
            except Exception as e:
                log.warning("session refresh failed on %s: %s", self.call_id, e)
                await self.bye()
                if self.on_disconnect is not None:
                    self.on_disconnect()
                return

    def _in_dialog(self, msg: SipMessage, addr) -> None:
        if msg.method == "BYE":
            self.stack.send_response(msg, addr, 200, "OK")
            self._teardown(notify=True)
            return
        if msg.method == "ACK":
            return
        if msg.method == "INVITE":  # re-INVITE toward the caller leg
            if self._reinvite_pending:
                self.stack.send_response(msg, addr, 491, "Request Pending")
                return
            try:
                params = extract_rtp_params(msg.body.decode("utf-8", "replace"),
                                            accept=self.accept_codecs)
            except SdpNegotiationError:
                self.stack.send_response(msg, addr, 488, "Not Acceptable Here")
                return
            laddr = self.on_reinvite(params) if self.on_reinvite else \
                (self._media[0] if self._media else None)
            if laddr is None:
                self.stack.send_response(msg, addr, 488, "Not Acceptable Here")
                return
            body = build_sdp(laddr, params.codec, params.out_ptime).encode()
            self.stack.send_response(msg, addr, 200, "OK", body=body)
            return
        if msg.method == "UPDATE":
            self._handle_update(msg, addr)
            return
        self.stack.send_response(msg, addr, 501, "Not Implemented")

    # -- in-dialog request plumbing (mixin hooks) -----------------------------
    def _dialog_addr(self):
        return self.remote_addr

    def _local_na(self):
        return self.final.from_na

    def _remote_na(self):
        return self.final.to_na

    def _route_uri(self):
        contact = self.final.get("contact")
        return NameAddr.parse(contact).uri if contact else self.final.to_na.uri

    def _next_cseq(self) -> int:
        self._cseq += 1
        return self._cseq

    async def bye(self) -> None:
        if self.terminated or not self.connected:
            self.terminated = True
            return
        bye = self.stack.make_request("BYE", self._route_uri(),
                                      self._local_na(), self._remote_na(),
                                      call_id=self.call_id,
                                      cseq=self._next_cseq(), contact=False)
        try:
            await self.stack.send_request(bye, self.remote_addr, timeout=8.0)
        except TimeoutError:
            pass
        self._teardown()

    def _teardown(self, notify: bool = False) -> None:
        if self.terminated:
            return
        self.terminated = True
        self._cancel_session_timer()
        if self._refresh_task is not None:
            self._refresh_task.cancel()
            self._refresh_task = None
        if self._dialog_key:
            self.stack.dialogs.pop(self._dialog_key, None)
        if notify and self.on_disconnect is not None:
            self.on_disconnect()


class CallFailed(Exception):
    def __init__(self, code: int, reason: str):
        super().__init__(f"{code} {reason}")
        self.code = code
        self.reason = reason
