"""The port's C++ media engine (``infernos_tpu_torch/csrc/rtp_engine.cpp``)
against its Python oracles, and the port's G.722 codec.

Copies of ``tests/test_native.py`` (with its parameters) and of the three
G.722 tests of ``tests/test_codecs.py``, then G.722 bytes both ways against
the JAX package's codec.  Where ``g++`` exists the engine must build and
load: a failed build fails these tests instead of skipping them.
"""

import audioop
import shutil

import numpy as np
import pytest

from infernos_tpu_torch.media import native
from infernos_tpu_torch.media.jitter import JitterBuffer, RTPFrameType
from infernos_tpu_torch.media.rtp import RTPPacket, RTPPacketizer

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no C++ compiler")


def test_native_engine_builds_and_loads():
    assert native.available(), native.load_error()
    assert native.load_error() is None
    assert native.LIB.endswith("infernos_tpu_torch/build/librtpengine.so")


ALL_I16 = np.arange(-32768, 32768, dtype=np.int16)


def test_native_g711_matches_audioop():
    got = np.frombuffer(native.ulaw_encode(ALL_I16), np.uint8)
    want = np.frombuffer(audioop.lin2ulaw(ALL_I16.tobytes(), 2), np.uint8)
    np.testing.assert_array_equal(got, want)
    codes = bytes(range(256))
    np.testing.assert_array_equal(
        native.ulaw_decode(codes),
        np.frombuffer(audioop.ulaw2lin(codes, 2), "<i2"))
    got = np.frombuffer(native.alaw_encode(ALL_I16), np.uint8)
    want = np.frombuffer(audioop.lin2alaw(ALL_I16.tobytes(), 2), np.uint8)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        native.alaw_decode(codes),
        np.frombuffer(audioop.alaw2lin(codes, 2), "<i2"))


def test_native_g722_matches_python():
    from infernos_tpu_torch.audio.codecs.g722 import G722State

    rng = np.random.default_rng(0)
    t = np.arange(8000) / 16000.0
    pcm = (12000 * np.sin(2 * np.pi * 440 * t)
           + 500 * rng.standard_normal(len(t))).astype(np.int16)
    py_enc = G722State()
    want_wire = py_enc.encode(pcm)
    c = native.NativeG722()
    got_wire = c.encode(pcm)
    assert got_wire == want_wire  # bit-exact wire format
    py_dec = G722State()
    want_pcm = py_dec.decode(want_wire)
    d = native.NativeG722()
    got_pcm = d.decode(got_wire)
    np.testing.assert_array_equal(got_pcm, want_pcm)


def test_native_packetizer_matches_python():
    py = RTPPacketizer(8000, 20, ssrc=0xABCD1234, seq0=7)
    py.ts = 1000
    c = native.NativePacketizer(8000, 20, ssrc=0xABCD1234, seq0=7, ts0=1000)
    for i in range(5):
        if i == 3:
            py.skip(2)
            c.skip(2)
        payload = bytes([i]) * 160
        assert c.next_pkt(160, 0, payload) == py.next_pkt(160, 0, payload)


def _mk_pkts(n, seq0=0, ssrc=7):
    return [RTPPacket(2, False, 0, (seq0 + i) & 0xFFFF, 160 * i, ssrc,
                      bytes([i % 251]) * 160).build() for i in range(n)]


@pytest.mark.parametrize("scenario", ["inorder", "reorder", "loss", "dup", "wrap"])
def test_native_jitter_matches_python(scenario):
    pkts = _mk_pkts(24, seq0=0xFFF8 if scenario == "wrap" else 0)
    order = list(range(24))
    if scenario == "reorder":
        order[3], order[4] = order[4], order[3]
        order[10], order[12] = order[12], order[10]
    elif scenario == "loss":
        order = [i for i in order if i not in (5, 6, 15)]
    elif scenario == "dup":
        order = order[:8] + [4, 5] + order[8:]

    py = JitterBuffer(4)
    cj = native.NativeJitterBuffer(4)
    py_frames, c_frames = [], []
    for i in order:
        py_frames.extend(py.udp_in(pkts[i]))
        c_frames.extend(cj.udp_in(pkts[i]))
    assert len(py_frames) == len(c_frames)
    for pf, cf in zip(py_frames, c_frames):
        assert pf.type == cf.type
        assert pf.lseq == cf.lseq
        if pf.type == RTPFrameType.AUDIO:
            assert pf.rtp_data == cf.rtp_data
        else:
            assert (pf.lseq_start, pf.lseq_end, pf.ts_diff) == (
                cf.lseq_start, cf.lseq_end, cf.ts_diff)


def test_native_jitter_parse_error():
    from infernos_tpu_torch.media.rtp import RTPParseError

    cj = native.NativeJitterBuffer(4)
    with pytest.raises(RTPParseError):
        cj.udp_in(b"short")


def test_native_g722_speed():
    """The native codec should beat Python by a wide margin (hot path)."""
    import time

    from infernos_tpu_torch.audio.codecs.g722 import G722State

    pcm = (np.sin(np.arange(16000) * 0.1) * 10000).astype(np.int16)
    c = native.NativeG722()
    t0 = time.monotonic()
    c.encode(pcm)
    t_native = time.monotonic() - t0
    py = G722State()
    t0 = time.monotonic()
    py.encode(pcm)
    t_py = time.monotonic() - t0
    assert t_native < t_py / 10, (t_native, t_py)


# -- copies of the G.722 tests of tests/test_codecs.py ----------------------------------

def test_g722_roundtrip_snr():
    from infernos_tpu_torch.audio.codecs import G722Codec

    codec = G722Codec()
    t = np.arange(16000) / 16000.0
    # Band-limited speech-like signal (two tones under 3.4 kHz)
    x = (0.4 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 1320 * t)).astype(
        np.float32
    )
    payload = codec.encode(x)
    assert len(payload) == len(x) // 2  # 64 kbps: 1 byte / 2 samples @ 16 kHz
    y = codec.decode(payload)
    assert len(y) == len(x)
    # Discard codec adaptation + QMF delay, align by cross-correlation
    best = max(range(30), key=lambda k: float(np.dot(x[: len(x) - 30], y[k : len(x) - 30 + k])))
    xx, yy = x[: len(x) - 30], y[best : len(x) - 30 + best]
    xx, yy = xx[2000:], yy[2000:]
    snr = 10 * np.log10(np.sum(xx**2) / np.sum((xx - yy) ** 2))
    assert snr > 20, (snr, best)


def test_g722_silence_roundtrip():
    from infernos_tpu_torch.audio.codecs import G722Codec

    enc = G722Codec()
    payload = enc.silence(160)
    assert len(payload) == 160
    out = G722Codec().decode(payload)
    assert len(out) == 320
    assert np.abs(out[100:]).max() < 0.01


def test_g722_frame_math():
    from infernos_tpu_torch.audio.codecs import G722Codec

    codec = G722Codec()
    # 20 ms packet = 160 encoded octets = 320 samples @ 16 kHz
    assert codec.e2d_frames(160) == 320
    assert codec.d2e_frames(320) == 160
    assert codec.e2d_frames(160, out_srate=8000) == 160


# -- against the JAX package -------------------------------------------------------------

@pytest.mark.parametrize("direction", ["encode", "decode"])
def test_g722_bytes_match_jax(direction):
    """The port's codec (native engine) and the JAX package's give the same
    wire bytes and the same samples, stream after stream (state carries)."""
    from infernos_tpu.audio.codecs import G722Codec as JG722
    from infernos_tpu_torch.audio.codecs import G722Codec

    rng = np.random.default_rng(5)
    ours, theirs = G722Codec(), JG722()
    for k in range(5):  # 20 ms packets of a voiced signal with noise
        t = (np.arange(320) + 320 * k) / 16000.0
        x = (0.3 * np.sin(2 * np.pi * 300 * t) + 0.05 * rng.standard_normal(320)
             ).astype(np.float32)
        if direction == "encode":
            assert ours.encode(x) == theirs.encode(x)
        else:
            wire = rng.integers(0, 256, 160, dtype=np.uint8).tobytes()
            np.testing.assert_array_equal(ours.decode(wire), theirs.decode(wire))
