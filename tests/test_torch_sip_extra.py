"""SIP extras: in-dialog re-INVITE renegotiation and digest REGISTER flow.

The port's copy of ``tests/test_sip_extra.py``, run against ``infernos_tpu_torch``.
"""

import asyncio
import hashlib

import pytest

from infernos_tpu_torch.audio.codecs import G711Codec
from infernos_tpu_torch.sip.message import NameAddr, SipMessage, SipURI, gen_branch, gen_tag
from infernos_tpu_torch.sip.registration import RegistrationAgent
from infernos_tpu_torch.sip.sdp import build_sdp, extract_rtp_params
from infernos_tpu_torch.sip.stack import SIPStack
from infernos_tpu_torch.sip.ua import UAC, UAS


def _run(coro, timeout=15.0):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def test_reinvite_renegotiates_media():
    async def scenario():
        a, b = SIPStack(), SIPStack()
        await a.start()
        await b.start()
        reinvites = []

        def on_invite(msg, addr):
            uas = UAS(b, msg, addr)
            params = uas.negotiate()
            uas.on_reinvite = lambda p: (reinvites.append(p) or ("127.0.0.1", 31300))
            uas.accept(("127.0.0.1", 31300), params.codec)

        b.on_invite = on_invite
        uac = UAC(a)
        await uac.invite_call(
            SipURI(host=b.local_addr[0], port=b.local_addr[1]), cld="1",
            rtp_laddr=("127.0.0.1", 30300), codec=G711Codec, addr=b.local_addr)

        # hand-roll an in-dialog re-INVITE with a new media port + ptime
        final = uac.final
        re_inv = a.make_request(
            "INVITE", SipURI(host=b.local_addr[0], port=b.local_addr[1]),
            NameAddr.parse(final.get("from")), NameAddr.parse(final.get("to")),
            call_id=uac.call_id, cseq=5)
        re_inv.body = build_sdp(("127.0.0.1", 30302), G711Codec, ptime=30).encode()
        re_inv.set("content-type", "application/sdp")
        resp = await a.send_request(re_inv, b.local_addr, timeout=5.0)
        a.close()
        b.close()
        return resp, reinvites

    resp, reinvites = _run(scenario())
    assert resp.code == 200
    assert len(reinvites) == 1
    assert reinvites[0].rtp_target == ("127.0.0.1", 30302)
    assert reinvites[0].out_ptime == 30
    # the 200 carries a fresh SDP answer
    answer = extract_rtp_params(resp.body.decode())
    assert answer.rtp_target == ("127.0.0.1", 31300)


def test_register_with_digest_challenge():
    async def scenario():
        registrar = SIPStack()
        await registrar.start()
        seen = {"challenged": False, "authorized": None}

        # minimal registrar: 401 first, verify digest on retry
        orig_handler = registrar._handle_request

        def handle(msg, addr):
            if msg.method != "REGISTER":
                return orig_handler(msg, addr)
            auth = msg.get("authorization")
            if auth is None:
                seen["challenged"] = True
                registrar.send_response(
                    msg, addr, 401, "Unauthorized",
                    extra={"www-authenticate":
                           'Digest realm="test", nonce="n123", algorithm=MD5'})
                return
            # verify the response hash
            import re as re_mod

            vals = {k: (x or y) for k, x, y in re_mod.findall(
                r'(\w+)=(?:"([^"]*)"|([^",\s]+))', auth)}
            h = lambda s: hashlib.md5(s.encode()).hexdigest()
            ha1 = h(f"alice:test:secret")
            ha2 = h(f"REGISTER:{vals['uri']}")
            want = h(f"{ha1}:n123:{ha2}")
            seen["authorized"] = (vals["response"] == want)
            registrar.send_response(msg, addr, 200, "OK")

        registrar._handle_request = handle

        client = SIPStack()
        await client.start()
        results = []
        agent = RegistrationAgent(client, registrar.local_addr, "alice",
                                  username="alice", password="secret",
                                  on_result=lambda ok, d: results.append(ok))
        ok = await agent.register_once()
        registrar.close()
        client.close()
        return ok, seen, results

    ok, seen, results = _run(scenario())
    assert seen["challenged"] is True
    assert seen["authorized"] is True
    assert ok is True and results and results[-1] is True


def test_retransmitted_request_gets_cached_response():
    async def scenario():
        srv = SIPStack()
        await srv.start()
        hits = []
        srv.on_invite = lambda msg, addr: (
            hits.append(1), UAS(srv, msg, addr).reject(486, "Busy Here"))

        cli = SIPStack()
        await cli.start()
        inv = cli.make_request(
            "INVITE", SipURI(host=srv.local_addr[0], port=srv.local_addr[1]),
            NameAddr(SipURI(user="x", host="h")).with_tag(gen_tag()),
            NameAddr(SipURI(user="y", host="h")))
        inv.add("via", f"SIP/2.0/UDP {cli.local_addr[0]}:{cli.local_addr[1]}"
                       f";branch={gen_branch()}")
        data = inv.build()
        # fire the identical datagram twice (UDP retransmission)
        cli.transport.sendto(data, srv.local_addr)
        cli.transport.sendto(data, srv.local_addr)
        await asyncio.sleep(0.3)
        srv.close()
        cli.close()
        return hits

    hits = _run(scenario())
    assert len(hits) == 1  # app saw the INVITE once; retransmit got the cache


def test_server_txn_cache_evicts_stale_entries(monkeypatch):
    """_server_last must not grow beyond the 32 s retransmission window."""
    from infernos_tpu_torch.sip import stack as stack_mod
    from infernos_tpu_torch.sip.message import SipMessage

    st = stack_mod.SIPStack.__new__(stack_mod.SIPStack)
    st._server_last = {}
    st._server_last_sweep = 0.0
    st._tcp_conns = {}

    class _FakeTransport:
        def sendto(self, data, addr):
            pass

    st.transport = _FakeTransport()
    clock = [1000.0]
    monkeypatch.setattr(stack_mod.time, "monotonic", lambda: clock[0])

    for i in range(20):
        req = SipMessage.parse(
            f"OPTIONS sip:a@b SIP/2.0\r\n"
            f"Via: SIP/2.0/UDP 1.2.3.4:5060;branch=z9hG4bK{i}\r\n"
            f"From: <sip:x@y>;tag=f{i}\r\nTo: <sip:a@b>\r\n"
            f"Call-ID: c{i}\r\nCSeq: 1 OPTIONS\r\n"
            f"Content-Length: 0\r\n\r\n".encode())
        st.send_response(req, ("1.2.3.4", 5060), 200, "OK")
        clock[0] += 10.0
    # 20 responses over 200 s, 32 s window -> only a handful may remain
    assert len(st._server_last) <= 6, len(st._server_last)
