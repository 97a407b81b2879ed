"""Griffin-Lim mel-inversion vocoder: deterministic and weight-free.

Port of ``infernos_tpu/audio/griffinlim.py`` on ``torch.fft``.  The in-repo
HiFi-GAN can only be trained GAN-less, and that checkpoint destroys the
formant detail the synthetic speech language lives in (copy-synthesis
intelligibility 0.34 against 0.97 for Griffin-Lim on the same mels), so the
tiny-real TTS vocodes with Griffin-Lim; the HiFi-GAN path
(``models/hifigan.py``) remains for real checkpoints.

Same semantics as the reference: the mel pseudo-inverse and the Hann window
are the "weights" (:func:`init_params`); a fixed number of phase-projection
iterations; framing is a strided view; overlap-add is a sum of
``n_fft // hop`` hop-strided shifts normalized by the overlap-added squared
window (:func:`_ola_norm`); the analysis reflect-pad of ``n_fft // 2`` is
trimmed from the result.  Interface-compatible with ``hifigan.apply`` so the
TTS engine dispatches on the config's type: ``apply(params, cfg,
logmel[B, T, M]) -> waveform [B, T * hop]``, computed in fp32 whatever the
mel's dtype.

The starting phase comes from :func:`init_phase`, a uniform draw in
[0, 2 pi) from a ``torch.Generator`` seeded with 12345.  The port's audio
is therefore deterministic (the same mel gives the same audio, on the CPU
and on the card alike), but it is **not** bit-equal to the JAX package's,
whose draw comes from ``jax.random.PRNGKey(12345)`` and cannot be
reproduced here.  The parity tests replace :func:`init_phase` with the JAX
draw.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..utils.platform import default_device
from .mel import mel_filterbank

PHASE_SEED = 12345


@dataclass(frozen=True)
class GriffinLimConfig:
    """Matches the tiny-TTS mel frontend (``tools/train_tiny_tts.mel80_np``):
    power spectrum -> mel -> log10, hop 256, win 1024 @ 16 kHz."""

    n_fft: int = 1024
    hop: int = 256
    n_mels: int = 80
    sample_rate: int = 16000
    fmax: float = 8000.0
    iters: int = 24
    model_in_dim: int = 80  # hifigan-interface parity (engine introspection)

    @property
    def total_upsample(self) -> int:
        return self.hop


def init_params(cfg: GriffinLimConfig, device=None) -> Dict[str, Any]:
    """The mel pseudo-inverse ``[F, M]`` and the window, fp32 tensors on
    ``default_device(device)``."""
    dev = default_device(device)
    fb = mel_filterbank(cfg.n_mels, cfg.n_fft, cfg.sample_rate,
                        fmax=cfg.fmax)  # [M, F]
    win = (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(cfg.n_fft)
                              / cfg.n_fft)).astype(np.float32)
    return {"fb_pinv": torch.from_numpy(np.linalg.pinv(fb)).to(dev),
            "win": torch.from_numpy(win).to(dev)}


@functools.lru_cache(maxsize=16)
def _ola_norm(n_fft: int, hop: int, n_frames: int) -> np.ndarray:
    """Overlap-added squared-window normalizer for ``n_frames`` frames."""
    win = (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n_fft) / n_fft))
    length = (n_frames - 1) * hop + n_fft
    wsum = np.zeros(length, np.float64)
    for i in range(n_frames):
        wsum[i * hop: i * hop + n_fft] += win ** 2
    return np.maximum(wsum, 1e-8).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _ola_norm_tensor(n_fft: int, hop: int, n_frames: int,
                     device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_ola_norm(n_fft, hop, n_frames)).to(device)


@functools.lru_cache(maxsize=64)
def _phase_draw(shape: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    g = torch.Generator(device="cpu").manual_seed(PHASE_SEED)
    return (torch.rand(shape, generator=g, dtype=torch.float32)
            * (2.0 * math.pi)).to(device)


def init_phase(shape, device) -> torch.Tensor:
    """The starting phase ``[B, T, F]``: uniform in [0, 2 pi), drawn on the
    host from a generator seeded with ``PHASE_SEED`` (so it does not depend
    on the device) and kept per shape and device: one tensor is shared by
    every call, so treat it as read-only."""
    return _phase_draw(tuple(int(n) for n in shape), torch.device(device))


def _frame(x: torch.Tensor, n_fft: int, hop: int, n_frames: int) -> torch.Tensor:
    """``[B, L] -> [B, n_frames, n_fft]`` (a strided view)."""
    return x.unfold(-1, n_fft, hop)[:, :n_frames]


def _istft(S: torch.Tensor, win: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """``[B, T, F]`` complex -> ``[B, (T-1)*hop + n_fft]`` by shift-and-sum
    overlap-add."""
    B, T, _ = S.shape
    frames = torch.fft.irfft(S, n=n_fft, dim=-1) * win
    k = n_fft // hop  # overlapping segments per output hop (4 for 1024/256)
    length = (T - 1) * hop + n_fft
    # segment j of frame t lands at (t + j) * hop: add each of the k
    # hop-strided planes at its offset
    seg = frames.reshape(B, T, k, hop)
    out = frames.new_zeros((B, length))
    for j in range(k):
        out[:, j * hop: j * hop + T * hop] += seg[:, :, j, :].reshape(B, T * hop)
    return out / _ola_norm_tensor(n_fft, hop, T, out.device)


def _stft(x: torch.Tensor, win: torch.Tensor, n_fft: int, hop: int,
          n_frames: int) -> torch.Tensor:
    return torch.fft.rfft(_frame(x, n_fft, hop, n_frames) * win, dim=-1)


@torch.no_grad()
def apply(params: Dict[str, Any], cfg: GriffinLimConfig,
          logmel: torch.Tensor) -> torch.Tensor:
    """``[B, T, M]`` log10 power-mel -> ``[B, T * hop]`` fp32 waveform.

    Mirrors ``hifigan.apply``'s contract (batch in, ``T * upsample``
    samples out, roughly in [-1, 1])."""
    B, T, _ = logmel.shape
    n_fft, hop = cfg.n_fft, cfg.hop
    power = torch.einsum("fm,btm->btf", params["fb_pinv"],
                         10.0 ** logmel.float()).clamp(min=0.0)
    mag = torch.sqrt(power)  # [B, T, F]
    S = torch.polar(mag, init_phase(mag.shape, mag.device))
    win = params["win"]
    for _ in range(cfg.iters):
        x = _istft(S, win, n_fft, hop)
        # re-frame the synthesized signal on the same grid (the analysis
        # window starts at t*hop; the signal is long enough by construction)
        Sn = _stft(x, win, n_fft, hop, T)
        S = mag * (Sn / Sn.abs().clamp(min=1e-8))
    x = _istft(S, win, n_fft, hop)
    # the analysis framing assumed a reflect-pad of n_fft//2: trim it
    return x[:, n_fft // 2: n_fft // 2 + T * hop]
