"""SIP stack tests: messages, SDP negotiation, full call flows over UDP.

The port's copy of ``tests/test_sip.py``, run against ``infernos_tpu_torch``.
"""

import asyncio

import pytest

from infernos_tpu_torch.audio.codecs import G711Codec, G722Codec
from infernos_tpu_torch.sip.message import NameAddr, SipMessage, SipURI
from infernos_tpu_torch.sip.sdp import (
    SdpNegotiationError,
    build_sdp,
    extract_rtp_params,
)
from infernos_tpu_torch.sip.stack import SIPStack, digest_response
from infernos_tpu_torch.sip.ua import UAC, UAS, CallFailed


def test_message_roundtrip():
    uri = SipURI.parse("sip:alice@example.com:5070;transport=udp")
    assert (uri.user, uri.host, uri.port) == ("alice", "example.com", 5070)
    msg = SipMessage.request("INVITE", uri)
    msg.add("via", "SIP/2.0/UDP 1.2.3.4:5060;branch=z9hG4bKabc")
    msg.add("from", '"Alice" <sip:alice@a.com>;tag=xyz')
    msg.add("to", "<sip:bob@b.com>")
    msg.add("call-id", "abc@host")
    msg.add("cseq", "1 INVITE")
    msg.body = b"hello"
    parsed = SipMessage.parse(msg.build())
    assert parsed.method == "INVITE"
    assert parsed.from_na.tag == "xyz"
    assert parsed.from_na.display == "Alice"
    assert parsed.via_branch == "z9hG4bKabc"
    assert parsed.body == b"hello"
    assert parsed.cseq == (1, "INVITE")


def test_response_construction():
    req = SipMessage.parse(
        b"INVITE sip:bob@b.com SIP/2.0\r\n"
        b"Via: SIP/2.0/UDP 1.2.3.4;branch=z9hG4bK1\r\n"
        b"From: <sip:a@a.com>;tag=ft\r\nTo: <sip:bob@b.com>\r\n"
        b"Call-ID: c1\r\nCSeq: 1 INVITE\r\nContent-Length: 0\r\n\r\n")
    resp = SipMessage.response_to(req, 200, "OK", to_tag="tt")
    out = SipMessage.parse(resp.build())
    assert out.code == 200
    assert out.to_na.tag == "tt"
    assert out.call_id == "c1"


def test_sdp_negotiation_prefers_g722():
    sdp = build_sdp(("10.0.0.1", 4000), G711Codec, 20,
                    extra_codecs=(G722Codec,))
    params = extract_rtp_params(sdp)
    assert params.codec is G722Codec  # wideband preferred
    assert params.rtp_target == ("10.0.0.1", 4000)
    params2 = extract_rtp_params(sdp, accept=(G711Codec,))
    assert params2.codec is G711Codec


def test_sdp_negotiation_failure():
    sdp = ("v=0\r\no=- 1 1 IN IP4 1.1.1.1\r\ns=-\r\nc=IN IP4 1.1.1.1\r\n"
           "t=0 0\r\nm=audio 4000 RTP/AVP 96\r\n")
    with pytest.raises(SdpNegotiationError):
        extract_rtp_params(sdp)


def test_sdp_ptime():
    sdp = build_sdp(("1.1.1.1", 5000), G711Codec, ptime=30)
    assert extract_rtp_params(sdp).out_ptime == 30


def test_digest_response_format():
    chal = ('Digest realm="sip.example.com", nonce="abc123", qop="auth", '
            'algorithm=MD5')
    hdr = digest_response(chal, "REGISTER", "sip:sip.example.com", "u", "p")
    assert hdr.startswith("Digest ")
    assert 'username="u"' in hdr and 'nonce="abc123"' in hdr and "qop=auth" in hdr


def _run(coro, timeout=15.0):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def test_full_call_flow():
    """UAC calls UAS over real UDP: lazy answer, media negotiation, BYE."""

    async def scenario():
        a, b = SIPStack(), SIPStack()
        await a.start()
        await b.start()
        events = []
        uas_holder = {}

        def on_invite(msg, addr):
            uas = UAS(b, msg, addr)
            uas_holder["uas"] = uas
            events.append("invite")
            uas.ring()
            params = uas.negotiate()
            events.append(("negotiated", params.codec.ename, params.rtp_target))
            uas.accept(("127.0.0.1", 31000), params.codec)
            uas.on_disconnect = lambda: events.append("uas-bye")

        b.on_invite = on_invite
        uac = UAC(a)
        params = await uac.invite_call(
            SipURI(host=b.local_addr[0], port=b.local_addr[1]), cld="200",
            rtp_laddr=("127.0.0.1", 30000), codec=G711Codec,
            addr=b.local_addr)
        assert uac.connected
        # answer advertises the UAS media address
        assert params.rtp_target == ("127.0.0.1", 31000)
        await uac.bye()
        await asyncio.sleep(0.1)
        a.close()
        b.close()
        return events

    events = _run(scenario())
    assert events[0] == "invite"
    neg = events[1]
    assert neg[0] == "negotiated" and neg[2] == ("127.0.0.1", 30000)
    assert "uas-bye" in events  # UAS learned about the BYE


def test_call_rejected():
    async def scenario():
        a, b = SIPStack(), SIPStack()
        await a.start()
        await b.start()
        b.on_invite = lambda msg, addr: UAS(b, msg, addr).reject(486, "Busy Here")
        uac = UAC(a)
        try:
            await uac.invite_call(
                SipURI(host=b.local_addr[0], port=b.local_addr[1]), cld="1",
                rtp_laddr=("127.0.0.1", 30002), codec=G711Codec,
                addr=b.local_addr)
            return None
        except CallFailed as e:
            return e.code
        finally:
            a.close()
            b.close()

    assert _run(scenario()) == 486


def test_uas_bye_terminates_uac():
    async def scenario():
        a, b = SIPStack(), SIPStack()
        await a.start()
        await b.start()
        holder = {}

        def on_invite(msg, addr):
            uas = UAS(b, msg, addr)
            holder["uas"] = uas
            uas.accept(("127.0.0.1", 31004), G711Codec)

        b.on_invite = on_invite
        uac = UAC(a)
        got_bye = asyncio.Event()
        await uac.invite_call(
            SipURI(host=b.local_addr[0], port=b.local_addr[1]), cld="1",
            rtp_laddr=("127.0.0.1", 30004), codec=G711Codec, addr=b.local_addr)
        uac.on_disconnect = got_bye.set
        await holder["uas"].bye()
        await asyncio.wait_for(got_bye.wait(), 5.0)
        a.close()
        b.close()
        return True

    assert _run(scenario())


def test_options_and_unknown_dialog():
    async def scenario():
        a, b = SIPStack(), SIPStack()
        await a.start()
        await b.start()
        opts = a.make_request("OPTIONS",
                              SipURI(host=b.local_addr[0], port=b.local_addr[1]),
                              NameAddr(SipURI(user="x", host="l")),
                              NameAddr(SipURI(user="y", host="r")))
        resp = await a.send_request(opts, b.local_addr, timeout=5.0)
        # BYE for a dialog that doesn't exist -> 481
        bye = a.make_request("BYE",
                             SipURI(host=b.local_addr[0], port=b.local_addr[1]),
                             NameAddr(SipURI(user="x", host="l")).with_tag("t1"),
                             NameAddr(SipURI(user="y", host="r")).with_tag("t2"))
        resp2 = await a.send_request(bye, b.local_addr, timeout=5.0)
        a.close()
        b.close()
        return resp.code, resp2.code

    assert _run(scenario()) == (200, 481)
