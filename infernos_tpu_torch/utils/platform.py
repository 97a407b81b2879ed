"""Device selection and card identity for the port.

The port runs on CUDA unless the caller asks for the CPU explicitly: there
is no silent fallback, so a missing card is an error, not a slow run.
"""

from __future__ import annotations

import subprocess
from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def full_fp32() -> None:
    """fp32 on the card is full fp32, as on the reference's devices: TF32
    (about three digits) neither in matmuls, which PyTorch already keeps
    off by default, nor in cuDNN's convolutions, which it turns on."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def default_device(device: DeviceLike = None) -> torch.device:
    """``device`` when given, else ``cuda``; raises when CUDA is absent.
    Selecting a CUDA device also sets :func:`full_fp32`."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card by default; pass "
                "device='cpu' explicitly to run the plain PyTorch path")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        full_fp32()
    return dev


def card_info() -> Optional[str]:
    """``name, power.limit`` of the first card as nvidia-smi reports it
    (the records keep it beside every number), or None without nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    return lines[0] if lines else None


def model_start_timeout() -> float:
    """Per-model-actor start timeout (seconds), ``INFERNOS_START_TIMEOUT``
    or 3600.  The reference sized it for a cold XLA compile; the port
    builds its kernels once per process (seconds with ``nvcc``) and keeps
    the same default so that a slow first start never aborts a daemon."""
    import os

    return float(os.environ.get("INFERNOS_START_TIMEOUT", "3600"))
