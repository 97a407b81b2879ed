"""Synthetic telephone-band pseudo-speech, the far ends' voice in the call
benches.

A copy of ``synth_speech`` and its helpers from ``tools/synth_speech.py``
(the generator the in-repo VAD was trained on), kept here so that the
port's benches make their speech without the reference's tools: formant
pseudo-speech (a glottal pulse train through vowel-like resonators,
syllabic gating, a voiced/unvoiced mix) at 8 kHz.  The same ``rng`` gives
the same samples as the tool.  ``synth_noise`` (the telephone-noise zoo) and
``make_example`` (speech over noise at a random SNR, with exact per-window
labels) are copies too: the port's VAD trainer draws its batches from them.
"""

from __future__ import annotations

import numpy as np
from scipy import signal as sig

SR = 8000


def _resonator(freq: float, bw: float, sr: int = SR):
    """2nd-order all-pole resonator (formant) coefficients."""
    r = np.exp(-np.pi * bw / sr)
    theta = 2 * np.pi * freq / sr
    a = [1.0, -2 * r * np.cos(theta), r * r]
    return [1.0 - r], a


def _syllabic_envelope(rng, n: int, rate_hz=(1.5, 6.0), sr: int = SR):
    """On/off speech gating at syllabic rate with smooth ~30 ms edges.
    Returns (envelope [n], active mask [n] bool)."""
    env = np.zeros(n, np.float32)
    pos = 0
    while pos < n:
        rate = rng.uniform(*rate_hz)
        # the tool draws this length and then draws it again; the first
        # draw is kept so that the generator's stream stays the tool's
        rng.uniform(0.35, 1.8)
        on = int(sr * rng.uniform(0.25, 1.5))
        off = int(sr * rng.uniform(0.1, 1.2))
        seg = min(on, n - pos)
        # intra-talkspurt syllable modulation (never drops to zero)
        t = np.arange(seg) / sr
        syl = 0.75 + 0.25 * np.sin(2 * np.pi * rate * t + rng.uniform(0, 6.28))
        env[pos : pos + seg] = syl
        pos += seg + off
    edge = int(0.030 * sr)
    if edge > 1:
        env = sig.lfilter(np.ones(edge) / edge, [1.0], env).astype(np.float32)
    return env, env > 0.15


def synth_speech(rng: np.random.Generator, seconds: float, sr: int = SR):
    """Formant pseudo-speech.  Returns (audio [n], speech mask [n] bool)."""
    n = int(seconds * sr)
    # glottal source: pulse train at wandering f0 + jitter
    f0 = rng.uniform(85, 280)
    drift = np.cumsum(rng.standard_normal(n) * 0.3)
    f0_t = np.clip(f0 * (1 + 0.002 * drift), 60, 350)
    phase = np.cumsum(2 * np.pi * f0_t / sr)
    # sawtooth-ish glottal pulse (sum of decaying harmonics)
    voiced = np.zeros(n, np.float32)
    for h in range(1, 9):
        voiced += np.sin(h * phase).astype(np.float32) / h
    unvoiced = rng.standard_normal(n).astype(np.float32)
    # voicing mix varies slowly (vowels vs fricatives)
    vmix = sig.lfilter(*sig.butter(2, 3.0 / (sr / 2)),
                       rng.standard_normal(n)).astype(np.float32)
    vmix = 0.5 + 0.5 * np.tanh(2.0 * vmix / (np.std(vmix) + 1e-9))
    src = vmix * voiced + 0.35 * (1 - vmix) * unvoiced

    # 3 formants with slow random walks around vowel-space centers
    out = np.zeros(n, np.float32)
    for lo, hi, bw in ((300, 900, 90), (900, 2200, 140), (2300, 3200, 220)):
        fc = rng.uniform(lo, hi)
        b, a = _resonator(fc, bw * rng.uniform(0.8, 1.6))
        out += sig.lfilter(b, a, src).astype(np.float32)

    env, active = _syllabic_envelope(rng, n)
    out *= env
    # telephone band-pass 300-3400
    b, a = sig.butter(2, [300 / (sr / 2), 3400 / (sr / 2)], btype="band")
    out = sig.lfilter(b, a, out).astype(np.float32)
    peak = np.abs(out).max() + 1e-9
    return (out / peak).astype(np.float32), active


def synth_noise(rng: np.random.Generator, seconds: float, sr: int = SR,
                kind: str = None) -> np.ndarray:
    """One of the telephone-noise zoo, peak-normalized."""
    n = int(seconds * sr)
    kind = kind or rng.choice(
        ["white", "pink", "hum", "tone", "dtmf", "clicks", "babble", "brown"])
    if kind == "white":
        x = rng.standard_normal(n)
    elif kind == "brown":
        x = np.cumsum(rng.standard_normal(n))
    elif kind == "pink":
        spec = np.fft.rfft(rng.standard_normal(n))
        f = np.maximum(np.fft.rfftfreq(n, 1 / sr), 1.0)
        x = np.fft.irfft(spec / np.sqrt(f), n)
    elif kind == "hum":
        base = rng.choice([50.0, 60.0])
        t = np.arange(n) / sr
        x = sum(np.sin(2 * np.pi * base * h * t + rng.uniform(0, 6)) / h
                for h in range(1, 6))
        x += 0.1 * rng.standard_normal(n)
    elif kind == "tone":
        t = np.arange(n) / sr
        x = np.sin(2 * np.pi * rng.uniform(300, 3000) * t)
        if rng.random() < 0.5:  # AM warble
            x *= 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(0.3, 4) * t)
    elif kind == "dtmf":
        lo = rng.choice([697, 770, 852, 941])
        hi = rng.choice([1209, 1336, 1477])
        t = np.arange(n) / sr
        gate = (np.sin(2 * np.pi * rng.uniform(1, 3) * t) > 0).astype(float)
        x = gate * (np.sin(2 * np.pi * lo * t) + np.sin(2 * np.pi * hi * t))
    elif kind == "clicks":
        x = np.zeros(n)
        for _ in range(max(1, int(seconds * rng.uniform(2, 12)))):
            p = rng.integers(0, n - 40)
            x[p : p + 40] += rng.standard_normal(40) * np.hanning(40) * 5
        x += 0.05 * rng.standard_normal(n)
    elif kind == "babble":
        # distant multi-talker: sum of speech synths, heavily smoothed --
        # a VAD should NOT fire on far-field babble
        x = np.zeros(n, np.float32)
        for _ in range(6):
            s, _ = synth_speech(rng, seconds, sr)
            x += s
        b, a = sig.butter(2, 1200 / (sr / 2))
        x = sig.lfilter(b, a, x)
    peak = np.abs(x).max() + 1e-9
    return (x / peak).astype(np.float32)


def make_example(rng: np.random.Generator, seconds: float, window: int,
                 sr: int = SR, p_speech: float = 0.65):
    """(audio [n], window labels [n//window]) -- speech mixed over noise at a
    random SNR, or pure noise/silence."""
    n = int(seconds * sr)
    noise = synth_noise(rng, seconds, sr)
    noise_gain = 10 ** (rng.uniform(-45, -12) / 20)
    audio = noise * noise_gain
    mask = np.zeros(n, bool)
    if rng.random() < p_speech:
        speech, mask = synth_speech(rng, seconds, sr)
        snr_db = rng.uniform(-2, 30)
        sp = np.sqrt(np.mean(speech[mask] ** 2) + 1e-12)
        npow = np.sqrt(np.mean(audio**2) + 1e-12)
        audio = audio + speech * (npow / sp) * 10 ** (snr_db / 20)
    peak = np.abs(audio).max()
    if peak > 1.0:
        audio = audio / peak
    # per-window labels: a window is speech when >=50% of it is active
    nw = n // window
    labels = mask[: nw * window].reshape(nw, window).mean(axis=1) >= 0.5
    return audio[: nw * window].astype(np.float32), labels.astype(np.float32)
