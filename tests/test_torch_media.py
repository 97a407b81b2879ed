"""Media plane of the port (``infernos_tpu_torch.media``), on the CPU.

Copies of ``tests/test_media.py`` on the port's modules (the ingest ring's
default VAD is the trained ``NeuralVAD``, here with ``device="cpu"``), then
port-against-JAX parity: the same seeded packet streams, with reordering,
loss, duplicates and sequence wrap, through both packages' jitter buffers
(Python and native), and the packetizers' bytes.
"""

import shutil
import time

import numpy as np
import pytest

from infernos_tpu_torch.audio.chunk import AudioChunk
from infernos_tpu_torch.audio.codecs import G711Codec
from infernos_tpu_torch.media.jitter import JitterBuffer, RTPFrameType
from infernos_tpu_torch.media.rtp import RTPPacket, RTPPacketizer, RTPParseError
from infernos_tpu_torch.media.pacer import RTPOutputWorker


@pytest.fixture(autouse=True, scope="module")
def _native_engine_built():
    """Build the native engine (where ``g++`` exists) before any test runs,
    so that the pacing tests time the pacer, not a first compile."""
    from infernos_tpu_torch.media import native

    native.available()


def test_rtp_roundtrip():
    p = RTPPacket(2, True, 0, 123, 456789, 0xDEADBEEF, b"\xff" * 160)
    q = RTPPacket.parse(p.build())
    assert (q.marker, q.ptype, q.seq, q.ts, q.ssrc, q.payload) == (
        True, 0, 123, 456789, 0xDEADBEEF, b"\xff" * 160)


def test_rtp_parse_errors():
    with pytest.raises(RTPParseError):
        RTPPacket.parse(b"short")
    with pytest.raises(RTPParseError):
        RTPPacket.parse(b"\x00" * 20)  # version 0


def test_packetizer_seq_ts_and_skip():
    rs = RTPPacketizer(8000, 20, ssrc=1, seq0=100)
    p1 = RTPPacket.parse(rs.next_pkt(160, 0, b"a" * 160))
    p2 = RTPPacket.parse(rs.next_pkt(160, 0, b"b" * 160))
    assert p1.marker and not p2.marker
    assert p2.seq == p1.seq + 1
    assert p2.ts == (p1.ts + 160) & 0xFFFFFFFF
    rs.skip(3)  # 3 idle packet times
    p3 = RTPPacket.parse(rs.next_pkt(160, 0, b"c" * 160))
    assert p3.seq == p2.seq + 1  # seq NOT consumed by skip
    assert p3.ts == (p2.ts + 160 + 3 * 160) & 0xFFFFFFFF
    assert p3.marker  # talkspurt start after silence


def _mk_pkts(n, seq0=0, ts0=0, ssrc=7):
    out = []
    for i in range(n):
        out.append(RTPPacket(2, False, 0, (seq0 + i) & 0xFFFF, ts0 + 160 * i,
                             ssrc, bytes([i % 251]) * 160).build())
    return out


def test_jitter_in_order():
    jb = JitterBuffer(8)
    lseqs = []
    for d in _mk_pkts(20):
        for f in jb.udp_in(d):
            assert f.type == RTPFrameType.AUDIO
            lseqs.append(f.lseq)
    assert lseqs == list(range(20))


def test_jitter_reorder():
    jb = JitterBuffer(8)
    pkts = _mk_pkts(6)
    order = [0, 2, 1, 3, 5, 4]
    got = []
    for i in order:
        got.extend(jb.udp_in(pkts[i]))
    assert [f.lseq for f in got] == list(range(6))
    assert all(f.type == RTPFrameType.AUDIO for f in got)


def test_jitter_loss_produces_ers():
    jb = JitterBuffer(4)
    pkts = _mk_pkts(20)
    got = []
    for i, d in enumerate(pkts):
        if i in (3, 4):  # lose two consecutive packets
            continue
        got.extend(jb.udp_in(d))
    kinds = [(f.type, f.lseq) for f in got]
    ers = [f for f in got if f.type == RTPFrameType.ERS]
    assert len(ers) == 1
    e = ers[0]
    assert (e.lseq_start, e.lseq_end) == (3, 4)
    assert e.ts_diff == 320  # two packets x 160 samples
    # strict lseq continuity for the consumer
    lseq = None
    for f in got:
        nxt = f.lseq_end if f.type == RTPFrameType.ERS else f.lseq
        if lseq is not None:
            start = f.lseq_start if f.type == RTPFrameType.ERS else f.lseq
            assert start == lseq + 1
        lseq = nxt


def test_jitter_duplicate_dropped():
    jb = JitterBuffer(8)
    pkts = _mk_pkts(3)
    out = []
    for d in [pkts[0], pkts[0], pkts[1], pkts[1], pkts[2]]:
        out.extend(jb.udp_in(d))
    assert [f.lseq for f in out] == [0, 1, 2]


def test_jitter_seq_wraparound():
    jb = JitterBuffer(8)
    out = []
    for d in _mk_pkts(10, seq0=0xFFFB):
        out.extend(jb.udp_in(d))
    assert [f.lseq for f in out] == list(range(0xFFFB, 0xFFFB + 10))


def test_pacer_paces_and_packetizes():
    codec = G711Codec()
    sent = []
    w = RTPOutputWorker(codec, lambda pkt: sent.append((time.monotonic(), pkt)),
                        ptime_ms=20)
    w.start()
    try:
        t = np.arange(1600) / 8000.0
        audio = (0.3 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)  # 200 ms
        t0 = time.monotonic()
        w.soundout(AudioChunk(audio, 8000))
        deadline = time.monotonic() + 3.0
        while len(sent) < 10 and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        w.end()
    assert len(sent) >= 10
    # packets are valid RTP with 160-byte payloads and consecutive seq
    seqs, stamps = [], []
    for ts, pkt in sent[:10]:
        p = RTPPacket.parse(pkt)
        assert len(p.payload) == 160
        seqs.append(p.seq)
        stamps.append(ts)
    assert seqs == list(range(seqs[0], seqs[0] + 10))
    # pacing: 10 packets of 20 ms should take ~180 ms (first sends immediately)
    span = stamps[-1] - stamps[0]
    assert 0.12 < span < 0.40, span


def test_endpoint_udp_loopback():
    """Two endpoints exchanging real UDP on localhost: TTS->RTP->VAD segs."""
    from infernos_tpu_torch.media.endpoint import RTPEndpoint, RTPParams
    from infernos_tpu_torch.media.ingest import AudioInput, RTPIngest
    from infernos_tpu_torch.media.udp import RTPPortAllocator

    ring = RTPIngest(device="cpu")
    ring.start()
    alloc = RTPPortAllocator(46000, 46500)
    try:
        ep_a = RTPEndpoint(ring, RTPParams(None, G711Codec), alloc)
        ep_b = RTPEndpoint(ring, RTPParams(None, G711Codec), alloc)
        # point them at each other
        ep_a.params.rtp_target = ep_b.local_addr
        ep_b.params.rtp_target = ep_a.local_addr

        segs, raw_flags = [], []
        ep_b.connect(AudioInput(audio_in=lambda c: raw_flags.append(c.active),
                                vad_chunk_in=segs.append))

        sr = 8000
        t = np.arange(sr) / sr
        speech = (0.4 * np.sin(2 * np.pi * 300 * t)).astype(np.float32)
        stream = np.concatenate([np.zeros(2000, np.float32), speech,
                                 np.zeros(sr, np.float32)])
        ep_a.soundout(AudioChunk(stream, sr))
        deadline = time.monotonic() + 8.0
        while not segs and time.monotonic() < deadline:
            time.sleep(0.05)
        assert segs, "no VAD segment arrived over the UDP loopback"
        assert 0.5 < segs[0].duration < 2.0
        assert any(raw_flags) and not all(raw_flags)
    finally:
        ep_a.shutdown()
        ep_b.shutdown()
        ring.stop()


def test_vad_signal_jingles():
    """Locally synthesized engage/disengage tones (reference VADSignals,
    Apps/LiveTranslator/LTSession.py:44-50, minus the network fetch)."""
    from infernos_tpu_torch.audio.signals import vad_signals

    for sr in (8000, 16000):
        eng, deng = vad_signals(sr)
        for tone in (eng, deng):
            assert tone.dtype == np.float32
            assert 0.1 * sr < len(tone) < 0.5 * sr  # short jingle
            assert 0.05 < np.abs(tone).max() <= 1.0
        # engage ascends (ends high), disengage descends (ends low):
        # distinguish by dominant frequency of the final 60 ms
        def dom_freq(x):
            tail = x[-int(0.06 * sr):]
            spec = np.abs(np.fft.rfft(tail))
            return np.fft.rfftfreq(len(tail), 1.0 / sr)[np.argmax(spec)]

        assert dom_freq(eng) > dom_freq(deng)


def _mk_pkt(seq, ts, payload=b"\xff" * 160, ssrc=7):
    from infernos_tpu_torch.media.rtp import RTPPacket

    import struct

    hdr = struct.pack("!BBHII", 0x80, 0, seq & 0xFFFF, ts & 0xFFFFFFFF, ssrc)
    return hdr + payload


def test_adaptive_jitter_depth():
    """Clean stream: a loss is declared after min_size (2) buffered packets,
    not the max depth (8); after observed reorder, the depth grows."""
    from infernos_tpu_torch.media.jitter import JitterBuffer, RTPFrameType

    jb = JitterBuffer(8)
    out = []
    for i in range(10):  # clean warm-up
        out += jb.udp_in(_mk_pkt(i, i * 160))
    assert all(f.type == RTPFrameType.AUDIO for f in out)
    # drop seq 10; deliver 11, 12: ERS must fire at the 2nd buffered packet
    assert jb.udp_in(_mk_pkt(11, 11 * 160)) == []
    frames = jb.udp_in(_mk_pkt(12, 12 * 160))
    assert frames and frames[0].type == RTPFrameType.ERS
    assert frames[0].ts_diff == 160

    # now teach it deep reorder: bursts arriving 5 packets out of order
    jb2 = JitterBuffer(8)
    seq = 0
    for i in range(10):
        jb2.udp_in(_mk_pkt(seq, seq * 160)); seq += 1
    jb2.udp_in(_mk_pkt(seq + 5, (seq + 5) * 160))  # future packet first
    for k in range(5):  # then the 5 it overtook
        jb2.udp_in(_mk_pkt(seq + k, (seq + k) * 160))
    seq += 6
    # effective depth is now ~5-6 (observed distance 5, slight decay): a NEW
    # gap must wait for >=5 buffered packets, not min_size=2
    got = []
    for k in range(1, 5):
        got += jb2.udp_in(_mk_pkt(seq + k, (seq + k) * 160))
    assert got == []  # only 4 buffered: still waiting
    frames = []
    for k in range(5, 8):
        frames += jb2.udp_in(_mk_pkt(seq + k, (seq + k) * 160))
        if frames:
            break
    assert frames and frames[0].type == RTPFrameType.ERS


def test_adaptive_jitter_native_parity():
    """The C++ jbuf implements the identical adaptive rule: same frame
    sequence for a reorder+loss script."""
    from infernos_tpu_torch.media import native
    from infernos_tpu_torch.media.jitter import JitterBuffer

    if shutil.which("g++") is None:
        pytest.skip("no C++ compiler")
    assert native.available(), native.load_error()  # a failed build fails
    script = []
    rng = np.random.default_rng(11)
    seq = 0
    while seq < 200:
        if rng.random() < 0.08 and seq > 10:  # reorder a small burst
            d = int(rng.integers(2, 6))
            order = list(range(seq, seq + d))[::-1]
            script += order
            seq += d
        elif rng.random() < 0.05:  # loss
            seq += int(rng.integers(1, 3))
        else:
            script.append(seq)
            seq += 1
    py = JitterBuffer(8)
    cc = native.NativeJitterBuffer(8)
    for s in script:
        data = _mk_pkt(s, s * 160)
        fp = py.udp_in(data)
        fc = cc.udp_in(data)
        assert [(f.type.value, f.lseq, f.rtp_data, f.ts_diff) for f in fp] == \
               [(f.type.value, f.lseq, f.rtp_data, f.ts_diff) for f in fc], s


def test_audio_chunk_from_url_local_http():
    """from_url fetches + decodes a WAV (reference AudioChunkFromURL,
    Core/AudioChunk.py:49-57) -- exercised against a localhost server so the
    test runs under zero egress."""
    import http.server
    import threading

    from infernos_tpu_torch.audio.chunk import AudioChunk

    tone = AudioChunk(
        (0.3 * np.sin(2 * np.pi * 440 * np.arange(8000) / 8000)).astype(np.float32),
        8000)
    wav = tone.to_wav_bytes()

    class H(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            self.send_response(200)
            self.send_header("Content-Length", str(len(wav)))
            self.end_headers()
            self.wfile.write(wav)

        def log_message(self, *a):
            pass

    srv = http.server.HTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{srv.server_port}/engage.wav"
        got = AudioChunk.from_url(url, track_id=2)
        assert got.samplerate == 8000 and got.track_id == 2
        assert np.abs(got.audio - tone.audio).max() < 1e-3
        got2 = AudioChunk.from_url(url)  # cached fetch
        assert len(got2.audio) == len(got.audio)
    finally:
        srv.shutdown()


def test_ingest_follows_sender_payload_type():
    """Negotiation said G.722 but the peer streams PCMU (observed with
    endpoints that list PCMU first yet accept our G722-preferring answer):
    the stream must follow the sender's pt on the FIRST packet instead of
    ADPCM-decoding mu-law bytes into garbage, and must DROP later packets
    whose pt matches nothing negotiated (comfort noise, DTMF)."""
    from infernos_tpu_torch.audio.codecs import G722Codec
    from infernos_tpu_torch.media.ingest import AudioInput, RTPIngest, RTPInStream

    ring = RTPIngest(device="cpu")
    ring.start()
    try:
        stream = RTPInStream(ring, G722Codec())  # negotiated: G722
        segs = []
        stream.stream_connect(AudioInput(vad_chunk_in=segs.append))
        # the peer sends PCMU (pt 0): 2 s of speech-band tone + 1 s tail
        sr = 8000
        t = np.arange(2 * sr) / sr
        speech = (0.5 * np.sin(2 * np.pi * 300 * t)
                  * (1 + 0.3 * np.sin(2 * np.pi * 3 * t))).astype(np.float32)
        sig = np.concatenate([np.zeros(1600, np.float32), speech,
                              np.zeros(sr, np.float32)])
        codec = G711Codec()
        rs = RTPPacketizer(8000, 20)
        for i in range(0, len(sig) - 159, 160):
            pkt = rs.next_pkt(160, 0, codec.encode(sig[i:i + 160]))
            stream.rtp_received(pkt, ("127.0.0.1", 1), time.monotonic())
        deadline = time.monotonic() + 8.0
        while not segs and time.monotonic() < deadline:
            time.sleep(0.05)
        assert stream.codec.ptype == 0, "stream did not follow the sender pt"
        assert segs, "no VAD segment from the pt-followed stream"
        cap = np.asarray(segs[0].audio)
        # mu-law decode is a table lookup: a correct capture is LOUD and
        # clean; the G722-misdecode bug produced rms ~0.54 of garbage
        assert 0.2 < float(np.sqrt((cap ** 2).mean())) < 0.5
        # a later unexpected pt (comfort noise 13) is dropped, not decoded
        cn = rs.next_pkt(160, 13, b"\x00" * 160)
        stream.rtp_received(cn, ("127.0.0.1", 1), time.monotonic())
        deadline = time.monotonic() + 2.0
        while stream.pt_dropped == 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert stream.pt_dropped == 1
    finally:
        ring.stop()


def test_udp_shared_selector_loop():
    """All UdpServer receive paths share one epoll thread (round-5 host-path
    fix: thread-per-socket recv was the dominant GIL churn at 32-call ramp
    levels).  Semantics preserved: per-socket callbacks, monotonic rtime,
    shutdown stops delivery and closes the socket."""
    import socket as socket_mod
    import threading
    import time as time_mod

    from infernos_tpu_torch.media.udp import UdpServer, _SelectorLoop

    got_a, got_b = [], []
    a = UdpServer(("127.0.0.1", 0), lambda d, ad, t: got_a.append((d, ad, t)))
    b = UdpServer(("127.0.0.1", 0), lambda d, ad, t: got_b.append((d, ad, t)))
    # both servers ride the ONE shared loop thread (no per-socket threads)
    assert a._thr is None and b._thr is None
    n_udp_threads = sum(1 for t in threading.enumerate()
                        if t.name.startswith("udp:"))
    assert n_udp_threads == 0
    tx = socket_mod.socket(socket_mod.AF_INET, socket_mod.SOCK_DGRAM)
    t0 = time_mod.monotonic()
    for i in range(5):
        tx.sendto(b"a%d" % i, a.laddr)
        tx.sendto(b"b%d" % i, b.laddr)
    deadline = time_mod.monotonic() + 5
    while (len(got_a) < 5 or len(got_b) < 5) and time_mod.monotonic() < deadline:
        time_mod.sleep(0.02)
    assert [d for d, _, _ in got_a] == [b"a0", b"a1", b"a2", b"a3", b"a4"]
    assert [d for d, _, _ in got_b] == [b"b0", b"b1", b"b2", b"b3", b"b4"]
    assert all(t0 <= t <= time_mod.monotonic() for _, _, t in got_a + got_b)
    # reply path still works from the shared-loop server socket
    a.send_to(b"pong", got_a[0][1])
    # shutdown: no more delivery, fd is closed on the loop thread
    b.shutdown()
    time_mod.sleep(0.1)
    tx.sendto(b"late", b.laddr)
    time_mod.sleep(0.3)
    assert len(got_b) == 5
    assert b.sock.fileno() == -1, "socket must be closed after shutdown"
    a.shutdown()
    tx.close()


# -- against the JAX package -----------------------------------------------------------

def _script(seed, n=400):
    """A seeded arrival order of sequence numbers with reordered bursts,
    losses and duplicates."""
    rng = np.random.default_rng(seed)
    out, seq = [], 0
    while seq < n:
        r = rng.random()
        if r < 0.08 and seq > 10:  # a burst overtaken by its last packet
            d = int(rng.integers(2, 7))
            out += [seq + d - 1] + list(range(seq, seq + d - 1))
            seq += d
        elif r < 0.13:  # loss of one or two packets
            seq += int(rng.integers(1, 3))
        elif r < 0.17 and out:  # a duplicate of a recent packet
            out.append(out[-int(rng.integers(1, min(len(out), 4) + 1))])
        else:
            out.append(seq)
            seq += 1
    return out


def _frames(jb, packets):
    got = []
    for p in packets:
        got += [(f.type.value, f.lseq, f.rtp_data, f.ts_diff,
                 f.lseq_start if f.type.value == RTPFrameType.ERS.value else 0)
                for f in jb.udp_in(p)]
    return got


@pytest.mark.parametrize("seed,seq0", [(0, 0), (1, 0xFFF0), (2, 0xFF80), (3, 1234)])
def test_jitter_buffers_match_jax(seed, seq0):
    """The port's Python and native jitter buffers give the JAX package's
    frames, byte for byte, on the same seeded stream (wrap included)."""
    from infernos_tpu.media import jitter as jjitter
    from infernos_tpu_torch.media import native

    packets = [_mk_pkt(seq0 + s, 1000 + 160 * s, payload=bytes([s % 251]) * 160)
               for s in _script(seed)]
    want = _frames(jjitter.JitterBuffer(8), packets)
    assert any(f[0] == 1 for f in want) and len(want) > 300
    assert _frames(JitterBuffer(8), packets) == want
    if shutil.which("g++") is not None:
        assert native.available(), native.load_error()
        assert _frames(native.NativeJitterBuffer(8), packets) == want


def test_packetizer_bytes_match_jax():
    from infernos_tpu.media import rtp as jrtp
    from infernos_tpu_torch.media import native

    rng = np.random.default_rng(4)
    py, jp = RTPPacketizer(8000, 20, ssrc=0x1234ABCD, seq0=0xFFFD), \
        jrtp.RTPPacketizer(8000, 20, ssrc=0x1234ABCD, seq0=0xFFFD)
    py.ts = jp.ts = 0xFFFFFF00
    pkts = [native.NativePacketizer(8000, 20, ssrc=0x1234ABCD, seq0=0xFFFD,
                                    ts0=0xFFFFFF00)] \
        if shutil.which("g++") is not None else []
    for i in range(40):
        if rng.random() < 0.2:
            n = int(rng.integers(1, 4))
            for p in (py, jp, *pkts):
                p.skip(n)
        payload = rng.integers(0, 256, 160, dtype=np.uint8).tobytes()
        want = jp.next_pkt(160, 0, payload)
        assert py.next_pkt(160, 0, payload) == want
        for p in pkts:
            assert p.next_pkt(160, 0, payload) == want


def test_rtp_parse_matches_jax():
    """Headers with CSRCs, an extension and padding parse to the same
    fields in both packages."""
    import struct

    from infernos_tpu.media import rtp as jrtp

    ext = struct.pack("!HH", 0xBEDE, 1) + b"\x01\x02\x03\x04"
    body = b"x" * 50 + b"\x00\x00\x03"  # 3 bytes of padding
    data = struct.pack("!BBHII", 0x80 | 0x20 | 0x10 | 2, 0x80 | 8, 7, 99, 5) \
        + b"\x00" * 8 + ext + body
    got, want = RTPPacket.parse(data), jrtp.RTPPacket.parse(data)
    assert got.__dict__ == want.__dict__
    assert got.build() == want.build()
    for bad in (b"short", b"\x00" * 20, data[:14]):
        with pytest.raises(RTPParseError):
            RTPPacket.parse(bad)
        with pytest.raises(jrtp.RTPParseError):
            jrtp.RTPPacket.parse(bad)
