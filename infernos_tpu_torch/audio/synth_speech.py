"""Synthetic telephone-band pseudo-speech, the far ends' voice in the call
benches.

A copy of ``synth_speech`` and its helpers from ``tools/synth_speech.py``
(the generator the in-repo VAD was trained on), kept here so that the
port's benches make their speech without the reference's tools: formant
pseudo-speech (a glottal pulse train through vowel-like resonators,
syllabic gating, a voiced/unvoiced mix) at 8 kHz.  The same ``rng`` gives
the same samples as the tool.
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
