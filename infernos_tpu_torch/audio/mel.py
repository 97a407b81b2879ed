"""Whisper-compatible log-mel frontend, batched in PyTorch.

Same framing, window, Slaney filterbank and clamp as the reference's
``log_mel_np``: reflect-pad ``n_fft // 2``, drop the final STFT frame,
per-sample 8-dB dynamic-range floor, then ``(x + 4) / 4``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16000
N_FFT = 400
HOP = 160


def _hz_to_mel(f):
    """Slaney mel scale (librosa htk=False)."""
    f = np.asarray(f, dtype=np.float64)
    mel = 3.0 * f / 200.0
    logstep = np.log(6.4) / 27.0
    return np.where(f >= 1000.0,
                    15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / logstep, mel)


def _mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    logstep = np.log(6.4) / 27.0
    return np.where(m >= 15.0, 1000.0 * np.exp(logstep * (m - 15.0)),
                    200.0 * m / 3.0)


@lru_cache(maxsize=8)
def mel_filterbank(n_mels: int = 128, n_fft: int = N_FFT, sr: int = SAMPLE_RATE,
                   fmin: float = 0.0, fmax: float = 8000.0) -> np.ndarray:
    """``[n_mels, n_fft//2+1]`` Slaney-normalized triangular filterbank."""
    fft_freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    mel_pts = np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    fb = np.maximum(0.0, np.minimum(lower, upper))
    fb *= (2.0 / (hz_pts[2: n_mels + 2] - hz_pts[:n_mels]))[:, None]
    return fb.astype(np.float32)


def log_mel(wav: torch.Tensor, n_mels: int = 128) -> torch.Tensor:
    """``[B, T]`` float waveform @16 kHz -> ``[B, n_mels, T // HOP]`` float32."""
    if wav.dim() == 1:
        wav = wav[None]
    dev = wav.device
    x = F.pad(wav.float()[:, None, :], (N_FFT // 2, N_FFT // 2),
              mode="reflect")[:, 0]
    # periodic Hann, as torch.hann_window and Whisper use
    window = torch.hann_window(N_FFT, periodic=True, dtype=torch.float32,
                               device=dev)
    frames = x.unfold(-1, N_FFT, HOP) * window  # [B, F, N_FFT]
    power = torch.fft.rfft(frames, dim=-1).abs() ** 2
    power = power[:, :-1, :]  # Whisper drops the final frame
    fb = torch.from_numpy(mel_filterbank(n_mels)).to(dev)
    mel = torch.einsum("mf,btf->bmt", fb, power)
    log_spec = torch.log10(mel.clamp_min(1e-10))
    floor = log_spec.amax(dim=(1, 2), keepdim=True) - 8.0
    log_spec = torch.maximum(log_spec, floor)
    return (log_spec + 4.0) / 4.0
