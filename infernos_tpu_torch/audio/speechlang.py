"""The renderer of the synthetic spoken language the tiny-real checkpoints
were trained on: text in, 16 kHz formant speech out.

A copy of the renderer half of ``tools/speechlang.py`` (``Speaker``,
``letter_formants``, ``render_letter``, ``render_text``), kept here so the
port can make a far end's speech without importing the reference package
(the tool's corpus half reads the reference's lexicon).  The same ``rng``
gives the same samples as the tool.

Each letter renders as a vowel-like formant gesture (harmonic glottal
source filtered by a letter-specific (F1, F2) resonator pair), words are
letter sequences, utterances are word sequences with pauses.  Speakers vary
in f0, rate, breathiness and spectral tilt; the noise level is drawn per
utterance.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

SR = 16000
LETTER_DUR = 0.095   # seconds per letter gesture (before rate scaling)
LETTER_GAP = 0.012
WORD_GAP = 0.11

ALPHABET = "abcdefghijklmnopqrstuvwxyz"

# (F1, F2) grid: 5 F1 x 6 F2 = 30 slots, telephone-band safe
_F1S = [280, 420, 560, 700, 840]
_F2S = [1250, 1600, 2000, 2450, 2950, 3300]


def letter_formants(ch: str) -> Tuple[float, float]:
    i = ALPHABET.index(ch)
    return float(_F1S[i % 5]), float(_F2S[i // 5])


@dataclass
class Speaker:
    f0: float
    rate: float       # duration multiplier
    breathiness: float
    tilt: float       # spectral tilt factor

    @classmethod
    def random(cls, rng: np.random.Generator) -> "Speaker":
        # f0 capped at 170 Hz: higher f0 quantizes formant peaks to the
        # harmonic comb and letters become ambiguous
        return cls(f0=float(rng.uniform(85, 170)),
                   rate=float(rng.uniform(0.85, 1.2)),
                   breathiness=float(rng.uniform(0.0, 0.08)),
                   tilt=float(rng.uniform(0.7, 1.0)))


def _resonator(freq: float, bw: float, sr: int = SR):
    r = np.exp(-np.pi * bw / sr)
    theta = 2 * np.pi * freq / sr
    return [1.0 - r], [1.0, -2 * r * np.cos(theta), r * r]


def _filt(b, a, x):
    from scipy import signal as sig

    return sig.lfilter(b, a, x).astype(np.float32)


def render_letter(rng: np.random.Generator, ch: str, spk: Speaker
                  ) -> np.ndarray:
    """One vowel-like gesture for a letter."""
    dur = LETTER_DUR * spk.rate * rng.uniform(0.9, 1.12)
    n = int(dur * SR)
    # glottal source: decaying harmonics at f0 with jitter + 5 Hz vibrato
    # (the vibrato sweeps harmonics through the resonances, so the
    # time-averaged spectrum shows the formant, not the harmonic comb)
    f0 = spk.f0 * rng.uniform(0.96, 1.04)
    t = np.arange(n) / SR
    vib = 1.0 + 0.03 * np.sin(2 * np.pi * 5.0 * t + rng.uniform(0, 6.28))
    drift = 1.0 + 0.01 * np.cumsum(rng.standard_normal(n)) / np.sqrt(n)
    phase = np.cumsum(2 * np.pi * f0 * vib * drift / SR)
    src = np.zeros(n, np.float32)
    for h in range(1, 10):
        src += (spk.tilt ** (h - 1)) * np.sin(h * phase).astype(np.float32) / h
    src += spk.breathiness * rng.standard_normal(n).astype(np.float32)
    f1, f2 = letter_formants(ch)
    jit = rng.uniform(0.985, 1.015, size=2)
    out = _filt(*_resonator(f1 * jit[0], 60.0), src)
    out = out + _filt(*_resonator(f2 * jit[1], 100.0), src)
    out = out + 0.25 * _filt(*_resonator(2900.0, 250.0), src)
    # 8 ms raised-cosine edges
    e = max(2, int(0.008 * SR))
    env = np.ones(n, np.float32)
    ramp = 0.5 - 0.5 * np.cos(np.pi * np.arange(e) / e)
    env[:e] = ramp
    env[-e:] = ramp[::-1]
    out *= env
    peak = np.abs(out).max() + 1e-9
    return (out / peak).astype(np.float32)


def render_text(rng: np.random.Generator, text: str,
                spk: Optional[Speaker] = None,
                snr_db: Optional[float] = None) -> np.ndarray:
    """Text (lowercase a-z + spaces) -> 16 kHz waveform."""
    if spk is None:
        spk = Speaker.random(rng)
    gap = np.zeros(int(LETTER_GAP * spk.rate * SR), np.float32)
    wgap = np.zeros(int(WORD_GAP * spk.rate * SR), np.float32)
    parts: List[np.ndarray] = []
    for w, word in enumerate(text.split()):
        if w:
            parts.append(wgap)
        for i, ch in enumerate(word):
            if ch not in ALPHABET:
                continue
            if i:
                parts.append(gap)
            parts.append(render_letter(rng, ch, spk))
    if not parts:
        return np.zeros(SR // 10, np.float32)
    audio = np.concatenate(parts)
    if snr_db is None:
        snr_db = float(rng.uniform(14, 40))
    sp = np.sqrt(np.mean(audio ** 2) + 1e-12)
    noise = rng.standard_normal(len(audio)).astype(np.float32)
    audio = audio + noise * sp * 10 ** (-snr_db / 20)
    peak = np.abs(audio).max() + 1e-9
    return (0.9 * audio / peak).astype(np.float32)
