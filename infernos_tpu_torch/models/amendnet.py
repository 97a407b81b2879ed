"""Chunk-boundary smoother for streaming vocoding (port of
``infernos_tpu/models/amendnet.py``): a small conv net over mel + audio
frames that predicts a per-sample gain mask hiding the seam between
independently vocoded chunks."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from . import layers as L
from .npz_io import data_path, load_params


@dataclasses.dataclass(frozen=True)
class AmendNetConfig:
    num_mels: int = 80
    frame_size: int = 256  # audio samples per mel frame (HiFi-GAN upsample)
    chunk_frames: int = 8
    pre_frames: int = 2
    post_frames: int = 2
    hidden: int = 128

    @property
    def total_frames(self) -> int:
        return self.pre_frames + self.chunk_frames + self.post_frames


def load_pretrained(device, dtype: Optional[torch.dtype] = None,
                    path: Optional[str] = None) -> Optional[Dict[str, Any]]:
    """The vendored trained smoother weights (read by file path from
    ``infernos_tpu/models/data/amendnet_weights.npz``), or None if absent."""
    return load_params(path or data_path("amendnet_weights.npz"), device, dtype)


def apply(params, cfg: AmendNetConfig, mel, audio):
    """mel ``[B, total_frames, num_mels]``, audio
    ``[B, total_frames * frame_size]`` -> ``[B, chunk_frames * frame_size]``."""
    B, T, _ = mel.shape
    frames = audio.reshape(B, T, cfg.frame_size)
    x = torch.cat([mel, frames.to(mel.dtype)], dim=-1)
    h = F.leaky_relu(L.conv1d(x, params["conv1"], padding=1), 0.1)
    h = F.leaky_relu(L.conv1d(h, params["conv2"], padding=1), 0.1)
    gain = 1.0 + torch.tanh(L.conv1d(h, params["out"], padding=1))
    amended = torch.tanh(frames * gain)
    s, e = cfg.pre_frames, cfg.pre_frames + cfg.chunk_frames
    return amended[:, s:e].reshape(B, cfg.chunk_frames * cfg.frame_size)
