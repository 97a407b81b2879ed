"""The port's SIP stack and config against the JAX package's.

- Messages: both packages parse the same raw SIP messages and serialise
  them to the same bytes; requests and responses built through the API
  from the same fields are byte-equal.
- SDP: offers and answers built from the same arguments are byte-equal
  (the clock that names the session is fixed), and both negotiate the same
  codec, target and ptime from the same bodies.
- Config: ``examples/*.yaml`` parse to equal ``dataclasses.asdict`` trees.
- Interop over loopback UDP: a JAX ``UAC`` calls a port ``UAS``, then a
  port ``UAC`` calls a JAX ``UAS``; each call is answered with the media
  address offered, and torn down by BYE on both sides.
"""

import asyncio
import dataclasses
import glob
import os

import pytest

import infernos_tpu.audio.codecs as j_codecs
import infernos_tpu.sip.message as j_msg
import infernos_tpu.sip.sdp as j_sdp
import infernos_tpu.sip.stack as j_stack
import infernos_tpu.sip.ua as j_ua
from infernos_tpu.config import InfernConfig as JConfig
import infernos_tpu_torch.audio.codecs as p_codecs
import infernos_tpu_torch.sip.message as p_msg
import infernos_tpu_torch.sip.sdp as p_sdp
import infernos_tpu_torch.sip.stack as p_stack
import infernos_tpu_torch.sip.ua as p_ua
from infernos_tpu_torch.config import InfernConfig as PConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SDP_BODY = (b"v=0\r\no=- 1700000000 1700000000 IN IP4 10.0.0.7\r\ns=-\r\n"
            b"c=IN IP4 10.0.0.7\r\nt=0 0\r\n"
            b"m=audio 40000 RTP/AVP 9 0 8 101\r\na=rtpmap:9 G722/8000\r\n"
            b"a=rtpmap:0 PCMU/8000\r\na=rtpmap:8 PCMA/8000\r\n"
            b"a=rtpmap:101 telephone-event/8000\r\na=ptime:30\r\na=sendrecv\r\n")

RAW = [
    (b"INVITE sip:900@127.0.0.1:5060 SIP/2.0\r\n"
     b"Via: SIP/2.0/UDP 10.0.0.7:5062;branch=z9hG4bKa1b2c3;rport\r\n"
     b"Max-Forwards: 70\r\n"
     b'From: "Alice" <sip:alice@10.0.0.7>;tag=f00d\r\n'
     b"To: <sip:900@127.0.0.1>\r\n"
     b"Call-ID: 4711@10.0.0.7\r\nCSeq: 1 INVITE\r\n"
     b"Contact: <sip:alice@10.0.0.7:5062>\r\n"
     b"Supported: 100rel, timer\r\nSession-Expires: 1800;refresher=uac\r\n"
     b"Content-Type: application/sdp\r\n"
     b"Content-Length: " + str(len(SDP_BODY)).encode() + b"\r\n\r\n" + SDP_BODY),
    (b"SIP/2.0 180 Ringing\r\n"
     b"Via: SIP/2.0/UDP 10.0.0.7:5062;branch=z9hG4bKa1b2c3;rport=5062\r\n"
     b'From: "Alice" <sip:alice@10.0.0.7>;tag=f00d\r\n'
     b"To: <sip:900@127.0.0.1>;tag=b0b\r\n"
     b"Call-ID: 4711@10.0.0.7\r\nCSeq: 1 INVITE\r\nRSeq: 1\r\n"
     b"Require: 100rel\r\nContent-Length: 0\r\n\r\n"),
    (b"REGISTER sip:sip.example.com SIP/2.0\r\n"
     b"v: SIP/2.0/UDP 10.0.0.7:5062;branch=z9hG4bKreg1\r\n"
     b"f: <sip:u@sip.example.com>;tag=r1\r\nt: <sip:u@sip.example.com>\r\n"
     b"i: reg-1@10.0.0.7\r\nCSeq: 2 REGISTER\r\nm: <sip:u@10.0.0.7:5062>\r\n"
     b'Authorization: Digest username="u", realm="sip.example.com", '
     b'nonce="abc", uri="sip:sip.example.com", response="00ff"\r\n'
     b"Expires: 3600\r\nl: 0\r\n\r\n"),
    (b"SIP/2.0 401 Unauthorized\r\n"
     b"Via: SIP/2.0/UDP 10.0.0.7:5062;branch=z9hG4bKreg1\r\n"
     b"From: <sip:u@sip.example.com>;tag=r1\r\n"
     b"To: <sip:u@sip.example.com>;tag=srv\r\nCall-ID: reg-1@10.0.0.7\r\n"
     b"CSeq: 1 REGISTER\r\n"
     b'WWW-Authenticate: Digest realm="sip.example.com", nonce="abc", '
     b"qop=\"auth\", algorithm=MD5\r\nContent-Length: 0\r\n\r\n"),
    (b"BYE sip:alice@10.0.0.7:5062 SIP/2.0\r\n"
     b"Via: SIP/2.0/UDP 127.0.0.1:5060;branch=z9hG4bKbye\r\n"
     b"Via: SIP/2.0/UDP 10.9.9.9:5060;branch=z9hG4bKproxy\r\n"
     b"From: <sip:900@127.0.0.1>;tag=b0b\r\n"
     b'To: "Alice" <sip:alice@10.0.0.7>;tag=f00d\r\n'
     b"Call-ID: 4711@10.0.0.7\r\nCSeq: 2 BYE\r\nContent-Length: 0\r\n\r\n"),
    (b"OPTIONS sip:127.0.0.1 SIP/2.0\r\n"
     b"Via: SIP/2.0/TCP 10.0.0.7:5062;branch=z9hG4bKopt\r\n"
     b"From: <sip:probe@10.0.0.7>;tag=o1\r\nTo: <sip:127.0.0.1>\r\n"
     b"Call-ID: opt-1\r\nCSeq: 7 OPTIONS\r\nAccept: application/sdp\r\n"
     b"Content-Length: 0\r\n\r\n"),
]


@pytest.mark.parametrize("raw", RAW, ids=["invite_sdp", "180_100rel",
                                          "register_compact", "401",
                                          "bye_two_vias", "options_tcp"])
def test_messages_parse_and_serialise_to_equal_bytes(raw):
    j, p = j_msg.SipMessage.parse(raw), p_msg.SipMessage.parse(raw)
    assert p.build() == j.build()
    for attr in ("method", "code", "reason", "call_id", "cseq", "via_branch",
                 "body"):
        assert getattr(p, attr, None) == getattr(j, attr, None), attr
    assert str(p.from_na) == str(j.from_na) and str(p.to_na) == str(j.to_na)


def test_built_requests_and_responses_are_byte_equal():
    out = []
    for m in (j_msg, p_msg):
        uri = m.SipURI.parse("sip:alice@example.com:5070;transport=udp")
        req = m.SipMessage.request("INVITE", uri)
        req.add("via", "SIP/2.0/UDP 1.2.3.4:5060;branch=z9hG4bKabc")
        req.add("from", str(m.NameAddr.parse("\"Al\" <sip:al@a.com>").with_tag("x")))
        req.add("to", "<sip:bob@b.com>")
        req.add("call-id", "abc@host")
        req.add("cseq", "1 INVITE")
        req.body = b"hello"
        resp = m.SipMessage.response_to(m.SipMessage.parse(req.build()), 486,
                                        "Busy Here", to_tag="tt")
        out.append((req.build(), resp.build(), str(uri)))
    assert out[0] == out[1]


@pytest.mark.parametrize("ptime,extra", [(20, False), (30, True)])
def test_sdp_build_and_negotiation_agree(monkeypatch, ptime, extra):
    monkeypatch.setattr(j_sdp.time, "time", lambda: 1700000000.5)
    monkeypatch.setattr(p_sdp.time, "time", lambda: 1700000000.5)
    j_extra = (j_codecs.G722Codec,) if extra else ()
    p_extra = (p_codecs.G722Codec,) if extra else ()
    js = j_sdp.build_sdp(("10.0.0.1", 4000), j_codecs.G711Codec, ptime,
                         extra_codecs=j_extra)
    ps = p_sdp.build_sdp(("10.0.0.1", 4000), p_codecs.G711Codec, ptime,
                         extra_codecs=p_extra)
    assert ps == js
    for body in (js, SDP_BODY.decode()):
        jp, pp = j_sdp.extract_rtp_params(body), p_sdp.extract_rtp_params(body)
        assert (pp.codec.ename, pp.rtp_target, pp.out_ptime) == \
            (jp.codec.ename, jp.rtp_target, jp.out_ptime)
        jp = j_sdp.extract_rtp_params(body, accept=(j_codecs.G711Codec,))
        pp = p_sdp.extract_rtp_params(body, accept=(p_codecs.G711Codec,))
        assert pp.codec.ename == jp.codec.ename == "PCMU"


def _tree(conf):
    def dc(x):
        return dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x

    return {"sip": dc(conf.sip_conf), "rtp": dc(conf.rtp_conf),
            "connectors": {k: dc(v) for k, v in conf.connectors.items()},
            "apps": {k: (type(v).__name__, dc(v)) for k, v in conf.apps.items()},
            "metrics": (conf.metrics_port, conf.metrics_bind),
            "precache": conf.precache}


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(ROOT, "examples", "*.yaml"))),
                         ids=os.path.basename)
def test_example_configs_parse_to_equal_trees(path):
    assert _tree(PConfig(path)) == _tree(JConfig(path))


def _interop(uac_side, uas_side):
    """``uac_side`` (stack, ua, codecs modules) calls ``uas_side``'s UAS over
    loopback UDP; returns what each side saw."""
    (us, uu, uc), (ss, su, sc) = uac_side, uas_side

    async def scenario():
        a, b = us.SIPStack(("127.0.0.1", 0)), ss.SIPStack(("127.0.0.1", 0))
        await a.start()
        await b.start()
        seen = {}

        def on_invite(msg, addr):
            uas = su.UAS(b, msg, addr, accept_codecs=(sc.G711Codec,))
            params = uas.negotiate()
            seen["offer"] = params.rtp_target
            seen["codec"] = params.codec.ename
            uas.on_disconnect = lambda: seen.setdefault("bye", True)
            uas.accept(("127.0.0.1", 31500), params.codec)

        b.on_invite = on_invite
        uac = uu.UAC(a, accept_codecs=(uc.G711Codec,))
        params = await uac.invite_call(
            uu.SipURI(host=b.local_addr[0], port=b.local_addr[1]), cld="900",
            rtp_laddr=("127.0.0.1", 30500), codec=uc.G711Codec, addr=b.local_addr)
        seen["connected"] = uac.connected
        seen["answer"] = params.rtp_target
        await uac.bye()
        for _ in range(50):
            if "bye" in seen:
                break
            await asyncio.sleep(0.02)
        seen["uac_terminated"] = uac.terminated
        a.close()
        b.close()
        return seen

    return asyncio.run(asyncio.wait_for(scenario(), 15.0))


JAX_SIDE = (j_stack, j_ua, j_codecs)
PORT_SIDE = (p_stack, p_ua, p_codecs)


@pytest.mark.parametrize("uac,uas", [(JAX_SIDE, PORT_SIDE), (PORT_SIDE, JAX_SIDE)],
                         ids=["jax_uac_port_uas", "port_uac_jax_uas"])
def test_interop_call_answered_and_torn_down(uac, uas):
    seen = _interop(uac, uas)
    assert seen == {"offer": ("127.0.0.1", 30500), "codec": "PCMU",
                    "connected": True, "answer": ("127.0.0.1", 31500),
                    "bye": True, "uac_terminated": True}
