"""Device selection and card identity for the port.

The port runs on CUDA unless the caller asks for the CPU explicitly: there
is no silent fallback, so a missing card is an error, not a slow run.
"""

from __future__ import annotations

import subprocess
from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def default_device(device: DeviceLike = None) -> torch.device:
    """``device`` when given, else ``cuda``; raises when CUDA is absent."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device='cpu' explicitly to run the plain PyTorch path")
    return torch.device("cuda")


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
