"""The port's copies of the host-side audio modules vs the originals:
G.711 bytes exact, decode exact, resampling within 1e-6, chunks and markers
with the same behaviour; ``resample_torch`` against the numpy path.
"""

import numpy as np
import pytest
import torch

from infernos_tpu.audio import chunk as jchunk
from infernos_tpu.audio import markers as jmarkers
from infernos_tpu.audio import resample as jrs
from infernos_tpu.audio.codecs import g711 as jg711
from infernos_tpu_torch.audio import chunk, markers
from infernos_tpu_torch.audio import resample as rs
from infernos_tpu_torch.audio.codecs import g711


def _signal(kind, n=4000):
    rng = np.random.default_rng(sum(map(ord, kind)))
    t = np.arange(n) / 8000.0
    return {
        "tone": 0.5 * np.sin(2 * np.pi * 440 * t),
        "noise": 0.3 * rng.standard_normal(n),
        "loud": 3.0 * rng.standard_normal(n),  # clips
        "quiet": 1e-4 * rng.standard_normal(n),
        "ramp": np.linspace(-1.0, 1.0, n),
        "zeros": np.zeros(n),
    }[kind].astype(np.float32)


SIGNALS = ["tone", "noise", "loud", "quiet", "ramp", "zeros"]


@pytest.mark.parametrize("kind", SIGNALS)
@pytest.mark.parametrize("law", ["G711Codec", "G711ACodec"])
def test_g711_bytes_and_decode_exact(kind, law):
    mine, ref = getattr(g711, law)(), getattr(jg711, law)()
    x = _signal(kind)
    payload = ref.encode(x)
    assert mine.encode(x) == payload
    np.testing.assert_array_equal(mine.decode(payload), ref.decode(payload))
    np.testing.assert_array_equal(
        mine.decode(payload, resample=True, sample_rate=16000),
        ref.decode(payload, resample=True, sample_rate=16000))
    assert mine.silence(160) == ref.silence(160)
    assert (mine.ptype, mine.ename, mine.rtpmap()) == (ref.ptype, ref.ename, ref.rtpmap())
    assert mine.e2d_frames(160, 16000) == ref.e2d_frames(160, 16000) == 320
    assert mine.d2e_frames(768, 8000) == ref.d2e_frames(768, 8000) == 768


def test_g711_tables_exact():
    np.testing.assert_array_equal(g711.ULAW_DECODE_TABLE, jg711.ULAW_DECODE_TABLE)
    np.testing.assert_array_equal(g711.ALAW_DECODE_TABLE, jg711.ALAW_DECODE_TABLE)
    all_bytes = bytes(range(256))
    for law in ("G711Codec", "G711ACodec"):
        c = getattr(g711, law)()
        assert c.encode(c.decode(all_bytes)) == getattr(jg711, law)().encode(
            getattr(jg711, law)().decode(all_bytes))


RATES = [(8000, 16000), (16000, 8000), (16000, 22050), (22050, 16000),
         (8000, 24000), (16000, 16000)]


@pytest.mark.parametrize("rates", RATES, ids=lambda r: f"{r[0]}-{r[1]}")
@pytest.mark.parametrize("kind", ["tone", "noise"])
def test_resample_matches_reference(rates, kind):
    a, b = rates
    x = _signal(kind, 1234)
    want = jrs.resample(x, a, b)
    got = rs.resample(x, a, b)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert rs.out_len(len(x), a, b) == jrs.out_len(len(x), a, b) == len(want)
    if a != b:
        g = np.gcd(a, b)
        np.testing.assert_array_equal(rs.design_filter(b // g, a // g),
                                      jrs.design_filter(b // g, a // g))


@pytest.mark.parametrize("rates", RATES, ids=lambda r: f"{r[0]}-{r[1]}")
def test_resample_torch_matches_numpy_and_jax_paths(rates):
    a, b = rates
    x = np.stack([_signal("tone", 800), _signal("noise", 800)])
    got = rs.resample_torch(torch.from_numpy(x), a, b).numpy()
    want = np.stack([rs.resample(r, a, b) for r in x])
    assert got.shape == want.shape
    # fp32 taps and sums against the host path's float64
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    jgot = np.asarray(jrs.resample_jax(x, a, b))
    np.testing.assert_allclose(got, jgot, rtol=0, atol=2e-5)


def test_audio_chunk_same_behaviour():
    x = _signal("tone", 1600)
    for mod in (chunk, jchunk):
        c = mod.AudioChunk(x.astype(np.float64).reshape(2, -1), 8000, track_id=3)
        assert c.audio.dtype == np.float32 and c.audio.ndim == 1
        assert c.duration == 0.2 and c.track_id == 3 and c.active
    a = chunk.AudioChunk(x.copy(), 8000).resample(16000)
    b = jchunk.AudioChunk(x.copy(), 8000).resample(16000)
    assert a.samplerate == b.samplerate == 16000
    np.testing.assert_allclose(a.audio, b.audio, rtol=0, atol=1e-6)
    wav = chunk.AudioChunk(x, 8000).to_wav_bytes()
    assert wav == jchunk.AudioChunk(x, 8000).to_wav_bytes()
    np.testing.assert_array_equal(chunk.AudioChunk.from_wav_bytes(wav).audio,
                                  jchunk.AudioChunk.from_wav_bytes(wav).audio)


def test_vad_audio_chunk_append_zero_fills_the_gap():
    for mod in (chunk, jchunk):
        a = mod.VadAudioChunk(np.ones(100, np.float32), 8000, ipos=800)
        a.append(mod.VadAudioChunk(np.full(50, 2.0, np.float32), 8000, ipos=1000))
        assert len(a.audio) == 250 and a.tpos() == 0.1
        assert a.audio[99] == 1 and a.audio[100] == 0 and a.audio[199] == 0 \
            and a.audio[200] == 2
        a.append(mod.VadAudioChunk(np.zeros(10, np.float32), 8000, ipos=1050))
        assert len(a.audio) == 260
        with pytest.raises(AssertionError):
            a.append(mod.VadAudioChunk(np.zeros(10, np.float32), 8000, ipos=0))


def test_url_fetch_refuses_other_schemes():
    for mod in (chunk, jchunk):
        with pytest.raises(ValueError, match="unsupported URL scheme"):
            mod.AudioChunk.from_url("ftp://localhost/x.wav")


def test_markers_same_behaviour():
    for mod in (markers, jmarkers):
        fired = []
        m = mod.ASMarkerSentDoneCB(lambda: fired.append(1), sync=True, track_id=2)
        assert isinstance(m, mod.ASMarkerNewSent) and isinstance(m, mod.ASMarkerGeneric)
        m.on_proc()
        assert fired == [1] and m.track_id == 2 and m.sync
        assert mod.ASMarkerNewSent().track_id == 0
