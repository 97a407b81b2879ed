"""The synthetic spoken language the tiny-real checkpoints were trained
on: text in, 16 kHz formant speech out, and its corpus.

A copy of ``tools/speechlang.py`` (the renderer ``Speaker``,
``letter_formants``, ``render_letter``, ``render_text``; the corpus
``EN_WORDS``, ``PT_WORDS``, ``WORDS``, ``make_utterance``,
``transcript_corpus``, ``checkpoint_words``) and of the attendant intents of
``tools/train_tiny_llm.py`` (``DIGITS``, ``DEPTS``, ``intent_utterance``),
kept here so the port makes a far end's speech and a bench's prompts
without the reference's tools or package: the Portuguese words come from
the port's own lexicon (``t2t/lexicon.py``) and the checkpoints' corpora
are read by path (``models/npz_io.data_path``).  The same ``rng`` gives the
same samples and words as the tools.

Each letter renders as a vowel-like formant gesture (harmonic glottal
source filtered by a letter-specific (F1, F2) resonator pair), words are
letter sequences, utterances are word sequences with pauses.  Speakers vary
in f0, rate, breathiness and spectral tilt; the noise level is drawn per
utterance.
"""

from __future__ import annotations

import json
import os
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


# -- corpus -------------------------------------------------------------------

EN_WORDS = (
    "zero one two three four five six seven eight nine "
    "call the to my for please yes no hello thanks goodbye "
    "transfer billing sales support agent line hold wait back "
    "account number order status open close check pay card "
    "help now today monday friday morning evening new old "
    "can you me speak with from name is this that what when "
    "where need want have will get department service team "
    "manager office phone time date confirm cancel repeat"
).split()


def _pt_words():
    """The Portuguese side of the lexicon for ``EN_WORDS`` (what the
    LiveTranslator's pt leg can say), and its words not in ``EN_WORDS``."""
    from ..t2t.lexicon import EN_PT

    full = [EN_PT[w] for w in EN_WORDS if w in EN_PT]
    return full, [w for w in full if w not in EN_WORDS]


PT_WORDS, _PT_NEW = _pt_words()
WORDS = EN_WORDS + _PT_NEW

_LANG_VOCABS = {None: None, "en": EN_WORDS, "pt": PT_WORDS}


def make_utterance(rng: np.random.Generator, n_words: Tuple[int, int] = (2, 6),
                   spk: Optional[Speaker] = None,
                   words: Optional[List[str]] = None,
                   lang: Optional[str] = None) -> Tuple[np.ndarray, str]:
    """Random utterance -> (16 kHz audio, transcript).  ``lang`` picks a
    language-pure vocabulary ('en'/'pt'; None = the mixed corpus)."""
    vocab = words if words is not None else _LANG_VOCABS[lang]
    if vocab is None:
        vocab = WORDS
    k = int(rng.integers(n_words[0], n_words[1] + 1))
    picked = [vocab[int(rng.integers(0, len(vocab)))] for _ in range(k)]
    text = " ".join(picked)
    return render_text(rng, text, spk), text


def transcript_corpus(n: int, seed: int = 0,
                      words: Optional[List[str]] = None) -> List[str]:
    """``n`` transcripts of 2-6 words drawn from ``words`` (default
    ``WORDS``) by a generator seeded with ``seed``."""
    vocab = WORDS if words is None else words
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(2, 7))
        out.append(" ".join(vocab[int(rng.integers(0, len(vocab)))]
                            for _ in range(k)))
    return out


def checkpoint_words(name: str = "tiny_stt") -> List[str]:
    """The vocabulary a vendored tiny-real checkpoint was trained on: the
    trainers write ``corpus.json`` beside the weights; without one the
    checkpoint was trained on ``EN_WORDS``."""
    from ..models.npz_io import data_path

    path = os.path.join(data_path(name), "corpus.json")
    try:
        with open(path) as f:
            return list(json.load(f)["words"])
    except (OSError, KeyError, ValueError):
        return list(EN_WORDS)


# -- attendant intents (tools/train_tiny_llm.py) -----------------------------

DIGITS = "zero one two three four five six seven eight nine".split()
DEPTS = ["billing", "sales", "support"]


def intent_utterance(rng: np.random.Generator) -> str:
    """A caller's line: half carry a recognizable intent of the attendant
    policy the tiny LLM was trained on (``_intent_utterance`` there)."""
    kind = int(rng.integers(0, 8))
    if kind == 0:
        return f"transfer me to {DEPTS[int(rng.integers(0, 3))]} please"
    if kind == 1:
        n = int(rng.integers(2, 6))
        ds = " ".join(DIGITS[int(rng.integers(0, 10))] for _ in range(n))
        return f"my account number is {ds}"
    if kind == 2:
        return "check my account number please"
    if kind == 3:
        return "thanks goodbye"
    if kind == 4:
        return "can me speak with the manager"
    if kind == 5:
        return "cancel my order please"
    if kind == 6:
        return "what is my order status"
    return "hello good morning"
