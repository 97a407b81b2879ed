"""SIP robustness beyond the basic flows: PRACK/100rel, UPDATE, TCP.

NEXT.md item 8 / VERDICT r2 weak 6: 'matching' sippy's capability surface
(the reference inherits these from sippy for free).

The port's copy of ``tests/test_sip_rel_tcp.py``, run against ``infernos_tpu_torch``.
"""

import asyncio

from infernos_tpu_torch.audio.codecs import G711Codec
from infernos_tpu_torch.sip.message import SipURI
from infernos_tpu_torch.sip.stack import SIPStack
from infernos_tpu_torch.sip.ua import UAC, UAS


def _run(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


def test_reliable_provisional_prack_flow():
    """UAC advertises 100rel; UAS rings reliably; PRACK stops the
    provisional retransmission; call completes."""

    async def scenario():
        a, b = SIPStack(), SIPStack()
        await a.start()
        await b.start()
        state = {}

        def on_invite(msg, addr):
            uas = UAS(b, msg, addr)
            state["uas"] = uas
            assert uas._peer_supports_100rel()
            uas.ring()  # auto-reliable
            state["rel_armed"] = getattr(uas, "_rel_pending", None)

            async def answer_later():
                await asyncio.sleep(0.3)  # let PRACK land first
                params = uas.negotiate()
                uas.accept(("127.0.0.1", 31100), params.codec)

            asyncio.ensure_future(answer_later())

        b.on_invite = on_invite
        uac = UAC(a)
        await uac.invite_call(
            SipURI(host=b.local_addr[0], port=b.local_addr[1]), cld="1",
            rtp_laddr=("127.0.0.1", 30100), codec=G711Codec,
            addr=b.local_addr)
        await asyncio.sleep(0.1)
        uas = state["uas"]
        assert state["rel_armed"] is not None, "180 was not reliable"
        assert getattr(uas, "_rel_pending", "x") is None, \
            "PRACK did not clear the reliable provisional"
        await uac.bye()
        a.close()
        b.close()

    _run(scenario())


def test_update_refresh_and_media():
    """In-dialog UPDATE: bodyless refresh 200s; SDP offer renegotiates."""

    async def scenario():
        a, b = SIPStack(), SIPStack()
        await a.start()
        await b.start()
        holder = {}

        def on_invite(msg, addr):
            uas = UAS(b, msg, addr)
            holder["uas"] = uas
            params = uas.negotiate()
            uas.accept(("127.0.0.1", 31200), params.codec)

        b.on_invite = on_invite
        uac = UAC(a)
        await uac.invite_call(
            SipURI(host=b.local_addr[0], port=b.local_addr[1]), cld="2",
            rtp_laddr=("127.0.0.1", 30200), codec=G711Codec,
            addr=b.local_addr)
        # bodyless refresh
        res = await uac.update()
        assert res is None
        # media UPDATE: new RTP port, immediate SDP answer
        params = await uac.update(("127.0.0.1", 30202), G711Codec)
        assert params is not None
        assert params.rtp_target == ("127.0.0.1", 31200)
        await uac.bye()
        a.close()
        b.close()

    _run(scenario())


def test_call_flow_over_tcp():
    """Full INVITE/200/ACK/BYE over SIP/TCP streams (RFC 3261 18)."""

    async def scenario():
        a = SIPStack()
        b = SIPStack(enable_tcp=True)
        await a.start()
        await b.start()
        await a.connect_tcp(b.local_addr)
        assert a.is_tcp(b.local_addr)
        events = []

        def on_invite(msg, addr):
            uas = UAS(b, msg, addr)
            events.append("invite")
            # addr is the TCP peer; reply rides the same stream
            assert b.is_tcp(addr)
            params = uas.negotiate()
            uas.accept(("127.0.0.1", 31300), params.codec)
            uas.on_disconnect = lambda: events.append("uas-bye")

        b.on_invite = on_invite
        uac = UAC(a)
        params = await uac.invite_call(
            SipURI(host=b.local_addr[0], port=b.local_addr[1]), cld="3",
            rtp_laddr=("127.0.0.1", 30300), codec=G711Codec,
            addr=b.local_addr)
        assert uac.connected
        assert params.rtp_target == ("127.0.0.1", 31300)
        await uac.bye()
        await asyncio.sleep(0.1)
        assert "uas-bye" in events
        a.close()
        b.close()

    _run(scenario())


def test_tcp_framing_handles_split_and_coalesced_messages():
    """The stream parser must frame across arbitrary TCP segmentation."""
    from infernos_tpu_torch.sip.stack import _SipTcpConn

    got = []

    class FakeStack:
        _tcp_conns = {}

        def _handle_request(self, msg, addr):
            got.append(("req", msg.method, bytes(msg.body)))

        def _handle_response(self, msg, addr):
            got.append(("resp", msg.code))

    class FakeTransport:
        def get_extra_info(self, _):
            return ("1.2.3.4", 5060)

    conn = _SipTcpConn(FakeStack())
    conn.connection_made(FakeTransport())
    m1 = (b"OPTIONS sip:x SIP/2.0\r\nVia: SIP/2.0/TCP h;branch=z9hG4bKa\r\n"
          b"From: <sip:a@x>;tag=1\r\nTo: <sip:b@x>\r\nCall-ID: c1\r\n"
          b"CSeq: 1 OPTIONS\r\nContent-Length: 4\r\n\r\nBODY")
    m2 = (b"SIP/2.0 200 OK\r\nVia: SIP/2.0/TCP h;branch=z9hG4bKb\r\n"
          b"From: <sip:a@x>;tag=1\r\nTo: <sip:b@x>;tag=2\r\nCall-ID: c1\r\n"
          b"CSeq: 1 OPTIONS\r\nContent-Length: 0\r\n\r\n")
    stream = m1 + m2
    # feed in 7-byte shreds (worst-case splitting)
    for i in range(0, len(stream), 7):
        conn.data_received(stream[i:i + 7])
    assert got == [("req", "OPTIONS", b"BODY"), ("resp", 200)]
