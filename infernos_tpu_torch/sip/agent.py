"""SIP agent: the signaling-plane actor wiring calls to apps and media.

Capability parity with the reference's ``SIP/InfernSIP.py`` +
``Cluster/InfernSIPActor.py``: owns the SIP stack on a dedicated event loop
(the reference blocks one Ray concurrency slot in sippy's ED2 loop and
marshals control calls onto it, ``Cluster/InfernSIPActor.py:16-58``);
registers configured accounts; dispatches inbound INVITEs by matching the
source address against connector profiles (``SIP/InfernSIP.py:99-114``);
tracks sessions in a dict keyed by UUID; creates UAC legs for outbound calls
(``:117-123``).

The app-facing offer object carries bound ``accept``/``reject`` callables
(reference ``SIP/RemoteSession.py:8-17``); ``accept`` allocates the media
endpoint, answers with our SDP, and hands back the RTP session id so the app
can wire audio.
"""

from __future__ import annotations

import asyncio
import threading
import uuid as uuid_mod
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

from ..cluster.actors import Actor, ActorHandle
from ..config.config import InfernConfig, SIPProfileConf
from ..media.endpoint import RTPParams
from ..utils.logging import get_logger
from .message import SipMessage, SipURI
from .registration import RegistrationAgent
from .sdp import DEFAULT_ACCEPT
from .stack import SIPStack
from .ua import UAC, UAS, CallFailed, SipSessInfo

log = get_logger("sip.agent")


@dataclass
class AcceptResult:
    sip_sess_id: uuid_mod.UUID
    rtp_sess_id: uuid_mod.UUID
    rtp_params: RTPParams  # negotiated (target = remote media addr)


@dataclass
class SessionOffer:
    """Inbound-call offer delivered to an app actor."""

    sip_sess_id: uuid_mod.UUID
    sess_info: SipSessInfo
    accept: Callable[..., AcceptResult] = field(repr=False, default=None)
    reject: Callable[..., None] = field(repr=False, default=None)


@dataclass
class NewSessionRequest:
    """Outbound-call request from an app (reference
    ``SIP/RemoteSession.py`` NewRemoteSessionRequest)."""

    conn: str  # "sip/<name>"
    cld: str
    disc_cb: Optional[Callable[[], None]] = None


class _Sess:
    __slots__ = ("ua", "rtp_sess_id", "disc_cb", "profile")

    def __init__(self, ua, rtp_sess_id=None, disc_cb=None, profile=None):
        self.ua = ua
        self.rtp_sess_id = rtp_sess_id
        self.disc_cb = disc_cb
        self.profile = profile


class SIPAgent(Actor):
    """Runs the asyncio signaling loop; exposes control methods."""

    def __init__(self, iconf: InfernConfig, rtp_actor: ActorHandle,
                 app_actors: Optional[Dict[str, ActorHandle]] = None,
                 accept_codecs=DEFAULT_ACCEPT):
        self.iconf = iconf
        self.rtp_actor = rtp_actor
        self.app_actors = app_actors or {}
        self.accept_codecs = accept_codecs
        self.stack: Optional[SIPStack] = None
        self.sessions: Dict[uuid_mod.UUID, _Sess] = {}
        self.regs: Dict[str, RegistrationAgent] = {}
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._loop_ready = threading.Event()
        self._loop_thread: Optional[threading.Thread] = None

    # -- lifecycle -------------------------------------------------------------
    def on_start(self) -> None:
        self._loop_thread = threading.Thread(target=self._run_loop,
                                             daemon=True, name="sip-loop")
        self._loop_thread.start()
        assert self._loop_ready.wait(timeout=10.0), "SIP loop failed to start"

    def _run_loop(self) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop

        async def boot():
            self.stack = SIPStack(self.iconf.sip_conf.bind)
            await self.stack.start()
            self.stack.on_invite = self._on_invite
            for key, prof in self.iconf.connectors.items():
                if prof.register and prof.sip_server:
                    reg = RegistrationAgent(
                        self.stack, prof.sip_server,
                        aor_user=prof.username or prof.name,
                        username=prof.username or "",
                        password=prof.password or "")
                    self.regs[key] = reg
                    reg.start()
            self._loop_ready.set()

        loop.run_until_complete(boot())
        loop.run_forever()

    def on_stop(self) -> None:
        if self._loop is None:
            return

        def _shutdown():
            for reg in self.regs.values():
                reg.stop()
            if self.stack:
                self.stack.close()
            self._loop.stop()

        self._loop.call_soon_threadsafe(_shutdown)

    def _await(self, coro, timeout: float = 35.0):
        """Run a coroutine on the SIP loop from a foreign thread."""
        return asyncio.run_coroutine_threadsafe(coro, self._loop).result(timeout)

    def _call_on_loop(self, fn, *args):
        done = threading.Event()
        box = {}

        def run():
            try:
                box["r"] = fn(*args)
            except Exception as e:  # surface to caller
                box["e"] = e
            done.set()

        self._loop.call_soon_threadsafe(run)
        assert done.wait(timeout=10.0)
        if "e" in box:
            raise box["e"]
        return box.get("r")

    @property
    def local_addr(self) -> Tuple[str, int]:
        return self.stack.local_addr

    def ready_check(self) -> Tuple[str, int]:
        """Raises if the signaling stack failed to come up (e.g. bind error)."""
        if self.stack is None or self.stack.transport is None:
            raise RuntimeError("SIP stack is not listening (bind failed?)")
        return self.stack.local_addr

    # -- inbound ----------------------------------------------------------------
    def _match_profile(self, addr) -> Optional[SIPProfileConf]:
        """Route inbound INVITEs to a connector with a sink: exact source
        (host, port) match first, then host match, then any open inbound
        (reference matches source addr, SIP/InfernSIP.py:103-108)."""
        sinked = [p for p in self.iconf.connectors.values() if p.sink]
        for prof in sinked:
            if prof.sip_server and prof.sip_server == tuple(addr[:2]):
                return prof
        for prof in sinked:
            if prof.sip_server and prof.sip_server[0] == addr[0]:
                return prof
        for prof in sinked:
            if prof.sip_server is None:
                return prof
        return sinked[0] if sinked else None

    def _on_invite(self, msg: SipMessage, addr) -> None:
        """Runs on the SIP loop thread."""
        prof = self._match_profile(addr)
        if prof is None or not prof.sink:
            self.stack.send_response(msg, addr, 403, "Forbidden")
            return
        uas = UAS(self.stack, msg, addr, accept_codecs=self.accept_codecs)
        sess = _Sess(uas, profile=prof)
        self.sessions[uas.id] = sess
        uas.on_disconnect = lambda: self._ua_disconnected(uas.id)
        offer = SessionOffer(
            sip_sess_id=uas.id,
            sess_info=uas.get_session_info(),
            accept=lambda disc_cb=None, auto_answer=True, sid=uas.id: self.accept_session(
                sid, disc_cb=disc_cb),
            reject=lambda code=603, reason="Decline", sid=uas.id: self.reject_session(
                sid, code, reason),
        )
        app = self.app_actors.get(prof.sink)
        if app is None:
            log.warning("no app actor for sink %s; rejecting", prof.sink)
            uas.reject(500, "Server Internal Error")
            self.sessions.pop(uas.id, None)
            return
        app.call("new_sip_session_received", offer)

    # -- control API (callable from any thread via the actor mailbox) -----------
    def accept_session(self, sip_sess_id: uuid_mod.UUID,
                       disc_cb: Optional[Callable] = None) -> AcceptResult:
        sess = self.sessions[sip_sess_id]
        uas: UAS = sess.ua
        params = self._call_on_loop(uas.negotiate)
        rtp_sess_id, laddr = self.rtp_actor.ask_sync(
            "new_rtp_session", params)
        sess.rtp_sess_id = rtp_sess_id
        sess.disc_cb = disc_cb
        uas.on_reinvite = lambda p, sid=rtp_sess_id: (
            self.rtp_actor.call("rtp_session_update", sid, p) or laddr)
        self._call_on_loop(uas.accept, laddr, params.codec, params.out_ptime)
        return AcceptResult(sip_sess_id, rtp_sess_id, params)

    def reject_session(self, sip_sess_id: uuid_mod.UUID, code: int = 603,
                       reason: str = "Decline") -> None:
        sess = self.sessions.pop(sip_sess_id, None)
        if sess is None:
            return
        self._call_on_loop(sess.ua.reject, code, reason)

    def new_session(self, req: NewSessionRequest) -> AcceptResult:
        """Create an outbound leg through a configured connector."""
        prof = self.iconf.connectors[req.conn]
        assert prof.sip_server, f"connector {req.conn} has no sip_server"
        # media first: the INVITE offer advertises our RTP address
        # (reference allocates the RTP session before inviting,
        # SIP/InfernUAC.py:19-42)
        from ..audio.codecs import G711Codec

        hold = RTPParams(rtp_target=None, codec=G711Codec)
        rtp_sess_id, laddr = self.rtp_actor.ask_sync("new_rtp_session", hold)
        uac = UAC(self.stack, accept_codecs=self.accept_codecs)
        sess = _Sess(uac, rtp_sess_id=rtp_sess_id, disc_cb=req.disc_cb,
                     profile=prof)
        self.sessions[uac.id] = sess
        uac.on_disconnect = lambda: self._ua_disconnected(uac.id)
        try:
            params = self._await(uac.invite_call(
                SipURI(user=req.cld, host=prof.sip_server[0],
                       port=prof.sip_server[1]),
                cld=req.cld, rtp_laddr=laddr, codec=G711Codec,
                addr=prof.sip_server,
                username=prof.username or "", password=prof.password or "",
                cli=prof.username or "infernos"))
        except (CallFailed, TimeoutError):
            self.sessions.pop(uac.id, None)
            self.rtp_actor.call("rtp_session_end", rtp_sess_id, True)
            raise
        self.rtp_actor.call("rtp_session_update", rtp_sess_id, params)
        return AcceptResult(uac.id, rtp_sess_id, params)

    def sess_term(self, sip_sess_id: uuid_mod.UUID) -> None:
        sess = self.sessions.pop(sip_sess_id, None)
        if sess is None:
            return
        if sess.rtp_sess_id is not None:
            self.rtp_actor.call("rtp_session_end", sess.rtp_sess_id, True)
        try:
            self._await(sess.ua.bye(), timeout=10.0)
        except Exception:
            log.debug("bye failed for %s", sip_sess_id)

    def _ua_disconnected(self, sip_sess_id: uuid_mod.UUID) -> None:
        """Far end hung up (runs on the SIP loop thread)."""
        sess = self.sessions.pop(sip_sess_id, None)
        if sess is None:
            return
        if sess.rtp_sess_id is not None:
            self.rtp_actor.call("rtp_session_end", sess.rtp_sess_id, True)
        if sess.disc_cb is not None:
            sess.disc_cb()
