"""RTCP of the port (``infernos_tpu_torch.media.rtcp``): copies of
``tests/test_rtcp.py`` -- packet build/parse, receiver stats, a live
exchange between two endpoints -- and the same packets built and parsed by
the JAX package's module."""

import struct
import time

import numpy as np
import pytest

from infernos_tpu_torch.media import rtcp


def test_sr_rr_sdes_bye_roundtrip():
    rb = rtcp.ReportBlock(ssrc=7, fraction_lost=25, cum_lost=100,
                          ext_high_seq=5000, jitter=42.7)
    sr = rtcp.build_sr(1, rtp_ts=1234, pkt_count=50, octet_count=8000,
                       reports=[rb])
    sdes = rtcp.build_sdes(1, "leg-a")
    bye = rtcp.build_bye(1)
    recs = rtcp.parse(sr + sdes + bye)
    assert [r.pt for r in recs] == [rtcp.SR, rtcp.SDES, rtcp.BYE]
    s = recs[0]
    assert (s.ssrc, s.rtp_ts, s.pkt_count, s.octet_count) == (1, 1234, 50, 8000)
    got = s.reports[0]
    assert (got.ssrc, got.fraction_lost, got.cum_lost, got.ext_high_seq,
            int(got.jitter)) == (7, 25, 100, 5000, 42)
    assert recs[1].cname == "leg-a"

    rr = rtcp.build_rr(2, [rb])
    recs = rtcp.parse(rr)
    assert recs[0].pt == rtcp.RR and recs[0].reports[0].ssrc == 7


def test_rx_stats_loss_and_jitter():
    st = rtcp.RxStats(clock_rate=8000)

    def pkt(seq, ts):
        return struct.pack("!BBHII", 0x80, 0, seq, ts, 99) + b"\x00" * 160

    t = 0.0
    for i in range(100):
        if i in (30, 31, 60):  # 3 lost packets
            continue
        # 1 ms of arrival jitter
        t = i * 0.020 + (0.001 if i % 2 else 0.0)
        st.on_packet(pkt(i, i * 160), t)
    rb = st.report_block()
    assert rb is not None
    assert rb.cum_lost == 3
    assert rb.ext_high_seq == 99
    assert 0 < rb.fraction_lost < 30  # ~3%
    assert rb.jitter > 0  # nonzero interarrival jitter


@pytest.mark.e2e
def test_rtcp_exchange_between_endpoints():
    """Two live endpoints: reports flow both ways on rtp_port+1."""
    from infernos_tpu_torch.audio.chunk import AudioChunk
    from infernos_tpu_torch.audio.codecs import G711Codec
    from infernos_tpu_torch.media.endpoint import RTPEndpoint, RTPParams
    from infernos_tpu_torch.media.ingest import RTPIngest
    from infernos_tpu_torch.media.udp import RTPPortAllocator

    ring = RTPIngest(device="cpu")
    ring.start()
    alloc = RTPPortAllocator(47000, 47500)
    ep_a = ep_b = None
    try:
        ep_a = RTPEndpoint(ring, RTPParams(None, G711Codec), alloc)
        ep_b = RTPEndpoint(ring, RTPParams(None, G711Codec), alloc)
        assert ep_a.rtcp is not None and ep_b.rtcp is not None
        ep_a.rtcp.INTERVAL_S = 1.0
        ep_b.rtcp.INTERVAL_S = 1.0
        ep_a.rtcp._next_at = ep_b.rtcp._next_at = time.monotonic() + 0.5
        ep_a.params.rtp_target = ep_b.local_addr
        ep_b.params.rtp_target = ep_a.local_addr
        ep_a.rtcp.target = (ep_b.local_addr[0], ep_b.local_addr[1] + 1)
        ep_b.rtcp.target = (ep_a.local_addr[0], ep_a.local_addr[1] + 1)

        # stream audio a->b so A emits SRs and B has rx stats to report
        t = np.arange(16000) / 8000.0
        ep_a.soundout(AudioChunk(
            (0.3 * np.sin(2 * np.pi * 300 * t)).astype(np.float32), 8000))
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            if ep_a.rtcp.remote and ep_b.rtcp.remote:
                break
            time.sleep(0.2)
        # B received A's audio -> B's report about A's stream reached A
        assert ep_a.rtcp.remote, "no receiver report back at the sender"
        assert ep_a.rtcp.remote["fraction_lost"] < 0.05
        assert ep_a.rtcp.remote["jitter_ms"] >= 0.0
    finally:
        if ep_a:
            ep_a.shutdown()
        if ep_b:
            ep_b.shutdown()
        ring.stop()


def test_packets_match_jax():
    from infernos_tpu.media import rtcp as jrtcp

    rb = rtcp.ReportBlock(ssrc=9, fraction_lost=3, cum_lost=7,
                          ext_high_seq=70000, jitter=12.5)
    jrb = jrtcp.ReportBlock(ssrc=9, fraction_lost=3, cum_lost=7,
                            ext_high_seq=70000, jitter=12.5)
    pkts = (rtcp.build_sr(5, rtp_ts=99, pkt_count=3, octet_count=480, reports=[rb])
            + rtcp.build_rr(5, [rb]) + rtcp.build_sdes(5, "leg") + rtcp.build_bye(5))
    want = (jrtcp.build_sr(5, rtp_ts=99, pkt_count=3, octet_count=480, reports=[jrb])
            + jrtcp.build_rr(5, [jrb]) + jrtcp.build_sdes(5, "leg") + jrtcp.build_bye(5))
    # an SR carries the wall clock: compare all but its NTP timestamp
    assert pkts[:8] == want[:8] and pkts[16:] == want[16:]
    got = [(p.pt, p.ssrc) for p in rtcp.parse(want)]
    assert got == [(p.pt, p.ssrc) for p in jrtcp.parse(want)]
