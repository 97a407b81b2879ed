"""Locally synthesized audible VAD signals (engage / disengage jingles).

Capability parity with the reference's ``VADSignals``
(``Apps/LiveTranslator/LTSession.py:44-50``), which fetches engage/disengage
WAVs over HTTP at session-class setup.  A network fetch is both an
availability liability and impossible under zero egress, so the tones are
synthesized in-process: two short sine notes with raised-cosine edges --
ascending for *engage* (VAD captured your speech), descending for
*disengage*.  They ride their own mixer track so they overlay, not
interrupt, translated speech (reference marks the engage chunk
``track_id=2``, ``LTSession.py:47``).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np

# (frequency Hz, duration s) note pairs
_ENGAGE_NOTES = ((440.0, 0.085), (660.0, 0.10))
_DISENGAGE_NOTES = ((660.0, 0.085), (440.0, 0.10))
_GAIN = 0.25
_EDGE_S = 0.008  # raised-cosine fade at each note edge (declick)


def _note(freq: float, dur: float, sr: int) -> np.ndarray:
    n = int(round(dur * sr))
    t = np.arange(n, dtype=np.float32) / sr
    x = np.sin(2.0 * np.pi * freq * t).astype(np.float32)
    e = min(int(_EDGE_S * sr), n // 2)
    if e > 0:
        ramp = 0.5 - 0.5 * np.cos(np.pi * np.arange(e, dtype=np.float32) / e)
        x[:e] *= ramp
        x[-e:] *= ramp[::-1]
    return x


def _jingle(notes, sr: int) -> np.ndarray:
    return (_GAIN * np.concatenate([_note(f, d, sr) for f, d in notes])) \
        .astype(np.float32)


@lru_cache(maxsize=8)
def vad_signals(sample_rate: int = 8000) -> Tuple[np.ndarray, np.ndarray]:
    """(engage, disengage) float32 jingles at ``sample_rate``."""
    return (_jingle(_ENGAGE_NOTES, sample_rate),
            _jingle(_DISENGAGE_NOTES, sample_rate))
