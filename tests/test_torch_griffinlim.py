"""Griffin-Lim mel inversion of the port (``audio/griffinlim.py``, on
``torch.fft``), on the CPU.

- Copies of ``tests/test_griffinlim.py``: shape and range, the mel round
  trip, determinism, and the TTS engine serving the Griffin-Lim vocoder;
- against ``infernos_tpu.audio.griffinlim.apply`` with the JAX phase draw
  injected (the port's own draw comes from a torch generator and is not
  bit-equal): within 1e-3 of the reference's peak in fp32, on random mels
  and on mels of the trained tiny TTS.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from infernos_tpu.audio import griffinlim as jgl
from infernos_tpu_torch.audio import griffinlim as gl
from infernos_tpu_torch.audio.mel import mel_filterbank


def _mel(wav, cfg):
    """Power-spectrum log10-mel, the tiny-TTS frontend convention."""
    n = (len(wav) // cfg.hop) * cfg.hop
    x = np.pad(wav[:n], (cfg.n_fft // 2, cfg.n_fft // 2), mode="reflect")
    n_frames = n // cfg.hop
    idx = np.arange(cfg.n_fft)[None, :] + cfg.hop * np.arange(n_frames)[:, None]
    win = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(cfg.n_fft) / cfg.n_fft)
    spec = np.abs(np.fft.rfft(x[idx] * win[None, :], axis=-1)) ** 2
    fb = mel_filterbank(cfg.n_mels, cfg.n_fft, cfg.sample_rate, fmax=cfg.fmax)
    return np.log10(np.maximum(spec @ fb.T, 1e-7)).astype(np.float32)


@pytest.fixture(scope="module")
def cfg():
    return gl.GriffinLimConfig(iters=24)


@pytest.fixture(scope="module")
def params(cfg):
    return gl.init_params(cfg, "cpu")


def _tone(freqs, n, sr=16000):
    t = np.arange(n) / sr
    return sum(0.3 * np.sin(2 * np.pi * f * t) for f in freqs).astype(np.float32)


def jax_phase(shape, device):
    """The reference's starting phase, in place of the port's draw."""
    ph = jax.random.uniform(jax.random.PRNGKey(12345), tuple(shape), jnp.float32,
                            0.0, 2.0 * np.pi)
    return torch.from_numpy(np.array(ph)).to(device)


# -- copies of tests/test_griffinlim.py ----------------------------------------------

def test_output_shape_and_range(cfg, params):
    mel = torch.from_numpy(np.random.default_rng(0).normal(-3.0, 1.0, (2, 20, 80))
                           .astype(np.float32))
    wav = gl.apply(params, cfg, mel).numpy()
    assert wav.shape == (2, 20 * cfg.hop)
    assert np.isfinite(wav).all()


def test_mel_round_trip_preserves_spectrum(cfg, params):
    """GL(mel) must re-analyse to nearly the same mel -- the property that
    makes copy-synthesis intelligible (formants land where they were)."""
    wav0 = _tone([300, 1600], 20 * cfg.hop)
    mel0 = _mel(wav0, cfg)
    wav1 = gl.apply(params, cfg, torch.from_numpy(mel0)[None])[0].numpy()
    mel1 = _mel(wav1, cfg)
    T = min(mel0.shape[0], mel1.shape[0])
    # compare in the well-conditioned (energetic) region
    mask = mel0[:T] > mel0.max() - 4.0
    err = np.abs(mel0[:T] - mel1[:T])[mask].mean()
    assert err < 0.35, err  # log10 units: < ~3.5 dB on formant peaks


def test_deterministic(cfg, params):
    mel = torch.from_numpy(np.random.default_rng(1).normal(-3.0, 1.0, (1, 12, 80))
                           .astype(np.float32))
    a = gl.apply(params, cfg, mel).numpy()
    b = gl.apply(params, cfg, mel).numpy()
    np.testing.assert_array_equal(a, b)


def test_engine_serves_griffinlim_vocoder():
    """TTSEngine dispatches on GriffinLimConfig and streams hop-aligned
    audio chunks end to end (random tiny t5; plumbing check)."""
    from infernos_tpu_torch.models import speecht5 as st5
    from infernos_tpu_torch.serving.tts_engine import TTSEngine, TTSEngineConfig

    tcfg = st5.SpeechT5Config(
        vocab_size=40, hidden_size=64, encoder_layers=1,
        encoder_attention_heads=4, encoder_ffn_dim=96, decoder_layers=2,
        decoder_attention_heads=4, decoder_ffn_dim=96, num_mel_bins=80,
        speech_decoder_prenet_units=16, speech_decoder_postnet_units=16,
        speaker_embedding_dim=16, max_text_positions=16,
        max_speech_positions=64)
    params = st5.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    vcfg = gl.GriffinLimConfig(iters=4)
    eng = TTSEngine(params, tcfg, gl.init_params(vcfg, "cpu"), vcfg,
                    TTSEngineConfig(batch_slots=2, max_text_tokens=16,
                                    max_steps=24, chunk_schedule=(8, 8)),
                    device="cpu")
    chunks, done = [], []
    eng.start_session(np.arange(4, dtype=np.int32),
                      np.zeros(16, np.float32),
                      lambda a: done.append(1) if a is None else chunks.append(a),
                      max_frames=16)
    while eng.step():
        pass
    assert done and chunks
    assert all(len(c) % vcfg.hop == 0 for c in chunks)
    assert np.isfinite(np.concatenate(chunks)).all()


# -- against the JAX package ---------------------------------------------------------

def test_params_equal_the_reference(cfg, params):
    jp = jgl.init_params(jgl.GriffinLimConfig(iters=24))
    np.testing.assert_array_equal(params["fb_pinv"].numpy(), np.asarray(jp["fb_pinv"]))
    np.testing.assert_array_equal(params["win"].numpy(), np.asarray(jp["win"]))
    for T in (1, 7, 36):
        np.testing.assert_array_equal(gl._ola_norm(cfg.n_fft, cfg.hop, T),
                                      jgl._ola_norm(cfg.n_fft, cfg.hop, T))


def _tiny_tts_mels(n_frames=36):
    """Mels shaped by the trained tiny TTS postnet (a realistic spectrum)."""
    from infernos_tpu_torch.models import speecht5 as st5
    from infernos_tpu_torch.models import tiny_real

    p, tcfg = tiny_real.load_tiny_tts("gl", device="cpu")[:2]
    x = torch.from_numpy(np.random.default_rng(2).normal(-3.0, 0.8, (1, n_frames, 80))
                         .astype(np.float32))
    return st5.postnet(p, tcfg, x)


@pytest.mark.parametrize("case", ["random", "tone", "tiny_tts_postnet", "one_frame"])
def test_matches_reference_with_its_phase(monkeypatch, params, case):
    jcfg = jgl.GriffinLimConfig(iters=24)
    cfg = gl.GriffinLimConfig(iters=24)
    rng = np.random.default_rng(3)
    if case == "random":
        mel = rng.normal(-3.0, 1.0, (3, 20, 80)).astype(np.float32)
    elif case == "tone":
        mel = _mel(_tone([220, 900, 2400], 36 * cfg.hop), cfg)[None]
    elif case == "tiny_tts_postnet":
        mel = _tiny_tts_mels().numpy().astype(np.float32)
    else:
        mel = rng.normal(-3.0, 1.0, (2, 1, 80)).astype(np.float32)
    want = np.asarray(jgl.apply(jgl.init_params(jcfg), jcfg, jnp.asarray(mel)))
    monkeypatch.setattr(gl, "init_phase", jax_phase)
    got = gl.apply(params, cfg, torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape == (mel.shape[0], mel.shape[1] * cfg.hop)
    peak = np.abs(want).max()
    err = np.abs(got - want).max() / peak
    print(f"griffin-lim {case}: max abs err {err:.3e} of peak {peak:.3e}")
    assert err <= 1e-3, err


def test_own_phase_is_seeded_and_independent_of_the_call():
    a = gl.init_phase((2, 5, 513), "cpu")
    g = torch.Generator().manual_seed(gl.PHASE_SEED)
    want = torch.rand((2, 5, 513), generator=g) * (2.0 * np.pi)
    assert torch.equal(a, want)
    assert a.min() >= 0 and a.max() < 2.0 * np.pi
    assert torch.equal(gl.init_phase(torch.Size([2, 5, 513]), torch.device("cpu")), a)
