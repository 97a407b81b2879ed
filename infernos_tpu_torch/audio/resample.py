"""Polyphase rational resampling (8k <-> 16k <-> 22.05k ...).

Capability parity: the reference resamples with cached
``torchaudio.transforms.Resample`` objects keyed by (from_sr, to_sr, device)
(``config/InfernGlobals.py:23-26``, ``Core/AudioChunk.py:19-24``).

One shared Kaiser-windowed-sinc filter design feeds two execution paths:

- **host path** (`resample`): scipy ``upfirdn`` for single streams on the
  media plane;
- **device path** (`resample_torch`): a zero-stuffed strided ``conv1d``,
  batched over all live sessions ``[B, T]`` in one call.

Both paths produce bit-identical filter taps, so outputs agree to float32
rounding with ``scipy.signal.resample_poly``'s default design
(window=('kaiser', 5.0), half_len=10*max_rate).
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Tuple

import numpy as np


@lru_cache(maxsize=64)
def design_filter(up: int, down: int) -> np.ndarray:
    """Kaiser(beta=5.0)-windowed sinc low-pass for a rational up/down pair.

    Matches scipy.signal.resample_poly's internal design so host and device
    paths are drop-in replacements for it.
    """
    assert up >= 1 and down >= 1
    max_rate = max(up, down)
    f_c = 1.0 / max_rate  # cutoff in Nyquist units
    half_len = 10 * max_rate
    n = np.arange(2 * half_len + 1) - half_len
    h = f_c * np.sinc(f_c * n) * np.kaiser(2 * half_len + 1, 5.0)
    h /= h.sum()  # unity DC gain
    return (h * up).astype(np.float64)


@lru_cache(maxsize=64)
def _plan(from_sr: int, to_sr: int) -> Tuple[int, int, np.ndarray, int, int]:
    g = math.gcd(from_sr, to_sr)
    up, down = to_sr // g, from_sr // g
    h = design_filter(up, down)
    half_len = (len(h) - 1) // 2
    # Pre-pad so the filter group delay is an integer number of output steps.
    n_pre_pad = (down - half_len % down) % down
    n_pre_remove = (half_len + n_pre_pad) // down
    return up, down, h, n_pre_pad, n_pre_remove


def out_len(n_in: int, from_sr: int, to_sr: int) -> int:
    g = math.gcd(from_sr, to_sr)
    up, down = to_sr // g, from_sr // g
    return -(-n_in * up // down)


def resample(x: np.ndarray, from_sr: int, to_sr: int) -> np.ndarray:
    """Host-path resample of a 1-D float array."""
    if from_sr == to_sr:
        return np.asarray(x, np.float32)
    from scipy.signal import upfirdn  # lazy: media plane only

    up, down, h, n_pre_pad, n_pre_remove = _plan(from_sr, to_sr)
    n_out = out_len(len(x), from_sr, to_sr)
    hp = np.concatenate([np.zeros(n_pre_pad), h])
    y = upfirdn(hp, np.asarray(x, np.float64), up, down)
    return y[n_pre_remove : n_pre_remove + n_out].astype(np.float32)


def resample_torch(x, from_sr: int, to_sr: int):
    """Device-path resample of a batched ``[B, T]`` float32 tensor (on the
    tensor's own device); same taps and trimming as :func:`resample`."""
    import torch
    import torch.nn.functional as F

    if from_sr == to_sr:
        return x
    up, down, h, n_pre_pad, n_pre_remove = _plan(from_sr, to_sr)
    B, T = x.shape
    n_out = out_len(T, from_sr, to_sr)
    hp = np.concatenate([np.zeros(n_pre_pad), h]).astype(np.float32)
    K = len(hp)
    # upfirdn(hp, x, up, down)[i] = full_conv(dilate(x, up), hp)[i*down]:
    # stuff up-1 zeros after each sample, correlate with the flipped taps
    # under full padding at stride ``down``, then trim the group delay.
    lhs = torch.zeros((B, 1, T * up), dtype=x.dtype, device=x.device)
    lhs[:, 0, ::up] = x
    lhs = lhs[:, :, : (T - 1) * up + 1]
    rhs = torch.from_numpy(hp[::-1].copy()).to(x.device, x.dtype)[None, None, :]
    y = F.conv1d(F.pad(lhs, (K - 1, K - 1 + down)), rhs, stride=down)[:, 0, :]
    return y[:, n_pre_remove : n_pre_remove + n_out]
