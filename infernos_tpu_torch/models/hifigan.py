"""HiFi-GAN vocoder in PyTorch (port of ``infernos_tpu/models/hifigan.py``,
HF ``SpeechT5HifiGan`` numerics, same parameter key paths and layouts)."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from . import layers as L


@dataclasses.dataclass(frozen=True)
class HifiGanConfig:
    model_in_dim: int = 80
    upsample_initial_channel: int = 512
    upsample_rates: Tuple[int, ...] = (4, 4, 4, 4)
    upsample_kernel_sizes: Tuple[int, ...] = (8, 8, 8, 8)
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    leaky_relu_slope: float = 0.1
    normalize_before: bool = True

    @property
    def total_upsample(self) -> int:
        out = 1
        for r in self.upsample_rates:
            out *= r
        return out


def _get_padding(k: int, d: int = 1) -> int:
    return (k * d - d) // 2


def init_params(cfg: HifiGanConfig, generator: torch.Generator, device,
                dtype=torch.float32) -> Dict[str, Any]:
    """Seeded random parameters (HF init: conv weights N(0, 0.01))."""
    g = generator

    def conv(c_in, c_out, k):
        return {"w": L.normal(g, (k, c_in, c_out), 0.01, device, dtype),
                "b": torch.zeros(c_out, device=device, dtype=dtype)}

    params: Dict[str, Any] = {
        "conv_pre": conv(cfg.model_in_dim, cfg.upsample_initial_channel, 7),
        "ups": [], "resblocks": [],
        "mean": torch.zeros(cfg.model_in_dim, device=device, dtype=dtype),
        "scale": torch.ones(cfg.model_in_dim, device=device, dtype=dtype),
    }
    ch = cfg.upsample_initial_channel
    for i, k in enumerate(cfg.upsample_kernel_sizes):
        c_out, c_in = ch // (2 ** (i + 1)), ch // (2 ** i)
        params["ups"].append({
            "w": L.normal(g, (k, c_out, c_in), 0.01, device, dtype),
            "b": torch.zeros(c_out, device=device, dtype=dtype)})
        for ksz, dils in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
            params["resblocks"].append({
                "convs1": [conv(c_out, c_out, ksz) for _ in dils],
                "convs2": [conv(c_out, c_out, ksz) for _ in dils]})
    params["conv_post"] = conv(ch // (2 ** len(cfg.upsample_rates)), 1, 7)
    return params


def _resblock(p, x, ksz, dils, slope):
    for c1, c2, d in zip(p["convs1"], p["convs2"], dils):
        r = x
        x = F.leaky_relu(x, slope)
        x = L.conv1d(x, c1, padding=_get_padding(ksz, d), dilation=d)
        x = F.leaky_relu(x, slope)
        x = L.conv1d(x, c2, padding=_get_padding(ksz, 1))
        x = x + r
    return x


def apply(params, cfg: HifiGanConfig, spectrogram):
    """``[B, T, n_mels]`` log-mel -> ``[B, T * total_upsample]`` waveform."""
    x = spectrogram
    if cfg.normalize_before:
        x = (x - params["mean"]) / params["scale"]
    x = L.conv1d(x, params["conv_pre"], padding=3)
    nk = len(cfg.resblock_kernel_sizes)
    for i, (rate, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        x = F.leaky_relu(x, cfg.leaky_relu_slope)
        x = L.conv_transpose1d(x, params["ups"][i], stride=rate,
                               padding=(k - rate) // 2)
        acc = None
        for j in range(nk):
            y = _resblock(params["resblocks"][i * nk + j], x,
                          cfg.resblock_kernel_sizes[j],
                          cfg.resblock_dilation_sizes[j], cfg.leaky_relu_slope)
            acc = y if acc is None else acc + y
        x = acc / nk
    x = F.leaky_relu(x, 0.01)  # HF uses the torch default slope here
    x = L.conv1d(x, params["conv_post"], padding=3)
    return torch.tanh(x)[:, :, 0]
