"""In-dialog SIP: outbound re-INVITE, 491 glare, RFC 4028 session timers.

Beyond reference: the reference delegates in-dialog handling to sippy and
never originates re-INVITEs or session refreshes (SURVEY section 2.3).

The port's copy of ``tests/test_sip_reinvite.py``, run against ``infernos_tpu_torch``.
"""

import asyncio
import threading

import pytest

from infernos_tpu_torch.audio.codecs import G711Codec
from infernos_tpu_torch.sip.message import SipURI
from infernos_tpu_torch.sip.stack import SIPStack
from infernos_tpu_torch.sip.ua import UAC, UAS


class LoopBox:
    """One asyncio loop on a thread hosting N stacks/UAs."""

    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self._thr = threading.Thread(target=self._run, daemon=True)
        self._thr.start()

    def _run(self):
        asyncio.set_event_loop(self.loop)
        self.loop.run_forever()

    def run(self, coro, timeout=30.0):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def close(self):
        self.loop.call_soon_threadsafe(self.loop.stop)


@pytest.fixture
def callpair():
    """Connected UAC<->UAS pair on one loop, plus their stacks."""
    box = LoopBox()
    state = {}

    async def boot():
        a = SIPStack(("127.0.0.1", 0))
        b = SIPStack(("127.0.0.1", 0))
        await a.start()
        await b.start()
        uas_box = {}

        def on_invite(msg, addr):
            uas = UAS(b, msg, addr)
            params = uas.negotiate()
            uas.accept(("127.0.0.1", 40000), params.codec)
            uas_box["uas"] = uas

        b.on_invite = on_invite
        uac = UAC(a)
        params = await uac.invite_call(
            SipURI(host=b.local_addr[0], port=b.local_addr[1]), cld="1",
            rtp_laddr=("127.0.0.1", 40002), codec=G711Codec, addr=b.local_addr)
        return a, b, uac, uas_box["uas"], params

    state["a"], state["b"], state["uac"], state["uas"], state["params"] = \
        box.run(boot())
    yield box, state
    try:
        box.run(state["a"].close() or asyncio.sleep(0))
    except Exception:
        pass
    box.close()


def test_uac_reinvite_updates_media(callpair):
    box, st = callpair
    uas, uac = st["uas"], st["uac"]
    seen = []

    def on_reinvite(params):
        seen.append(params.rtp_target)
        return ("127.0.0.1", 40010)  # our new media addr

    uas.on_reinvite = on_reinvite
    params = box.run(uac.reinvite(("127.0.0.1", 40004), G711Codec))
    assert seen and seen[0] == ("127.0.0.1", 40004)
    assert params.rtp_target == ("127.0.0.1", 40010)


def test_uas_reinvite_toward_caller(callpair):
    box, st = callpair
    uas, uac = st["uas"], st["uac"]
    uac.on_reinvite = lambda p: ("127.0.0.1", 40020)
    params = box.run(uas.reinvite(("127.0.0.1", 40006), G711Codec))
    assert params.rtp_target == ("127.0.0.1", 40020)


def test_glare_both_sides_settle(callpair):
    """Simultaneous re-INVITEs: 491 + role-based backoff; both settle."""
    box, st = callpair
    uas, uac = st["uas"], st["uac"]
    uas.on_reinvite = lambda p: ("127.0.0.1", 40030)
    uac.on_reinvite = lambda p: ("127.0.0.1", 40032)

    async def both():
        return await asyncio.gather(
            uac.reinvite(("127.0.0.1", 40034), G711Codec),
            uas.reinvite(("127.0.0.1", 40036), G711Codec),
        )

    p_uac, p_uas = box.run(both(), timeout=30.0)
    assert p_uac.rtp_target == ("127.0.0.1", 40030)
    assert p_uas.rtp_target == ("127.0.0.1", 40032)


def test_session_timer_expires_without_refresh():
    """Callee honors Session-Expires and BYEs when the refresher vanishes."""
    box = LoopBox()
    try:
        disconnected = threading.Event()

        async def boot():
            a = SIPStack(("127.0.0.1", 0))
            b = SIPStack(("127.0.0.1", 0))
            await a.start()
            await b.start()

            def on_invite(msg, addr):
                UAS.min_session_expires = 1  # fast test expiry
                uas = UAS(b, msg, addr)
                uas.accept(("127.0.0.1", 41000), uas.negotiate().codec)

            b.on_invite = on_invite
            uac = UAC(a)
            await uac.invite_call(
                SipURI(host=b.local_addr[0], port=b.local_addr[1]), cld="1",
                rtp_laddr=("127.0.0.1", 41002), codec=G711Codec,
                addr=b.local_addr, session_expires=1)
            uac._refresh_task.cancel()  # simulate a vanished refresher
            uac.on_disconnect = disconnected.set
            return uac

        uac = box.run(boot())
        # the UAS's expiry BYE must land within ~3 s
        assert disconnected.wait(6.0), "no expiry BYE from the callee"
    finally:
        UAS.min_session_expires = 90
        box.close()


def test_session_refresh_keeps_call_alive():
    box = LoopBox()
    try:
        disconnected = threading.Event()

        async def boot():
            a = SIPStack(("127.0.0.1", 0))
            b = SIPStack(("127.0.0.1", 0))
            await a.start()
            await b.start()

            def on_invite(msg, addr):
                UAS.min_session_expires = 2
                uas = UAS(b, msg, addr)
                uas.accept(("127.0.0.1", 41010), uas.negotiate().codec)

            b.on_invite = on_invite
            uac = UAC(a)
            await uac.invite_call(
                SipURI(host=b.local_addr[0], port=b.local_addr[1]), cld="1",
                rtp_laddr=("127.0.0.1", 41012), codec=G711Codec,
                addr=b.local_addr, session_expires=2)
            uac.on_disconnect = disconnected.set
            return uac

        uac = box.run(boot())
        # refresher re-INVITEs every 1 s; after 5 s the call must be alive
        assert not disconnected.wait(5.0), "refreshed call was torn down"
        assert not uac.terminated
        box.run(uac.bye())
    finally:
        UAS.min_session_expires = 90
        box.close()
