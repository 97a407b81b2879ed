"""Structured logging with monotonic timestamps.

Capability parity: the reference logs with ad-hoc ``print`` statements prefixed
by a monotonic timestamp helper (``IG.stdtss``, reference
``config/InfernGlobals.py:33-34``).  We provide the same helper plus a real
:mod:`logging`-based structured logger.
"""

from __future__ import annotations

import logging
import os
import sys
import time

_FMT = "%(asctime)s.%(msecs)03d %(levelname).1s %(name)s: %(message)s"
_DATEFMT = "%H:%M:%S"
_configured = False


def _configure_root() -> None:
    global _configured
    if _configured:
        return
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(_FMT, datefmt=_DATEFMT))
    root = logging.getLogger("infernos_tpu_torch")
    root.addHandler(handler)
    level = os.environ.get("INFERNOS_LOG_LEVEL", "INFO").upper()
    root.setLevel(getattr(logging, level, logging.INFO))
    root.propagate = False
    _configured = True


def get_logger(name: str) -> logging.Logger:
    """Return a logger under the ``infernos_tpu_torch`` hierarchy."""
    _configure_root()
    if not name.startswith("infernos_tpu_torch"):
        name = f"infernos_tpu_torch.{name}"
    return logging.getLogger(name)


def stdtss() -> str:
    """Monotonic timestamp string, second resolution with ms fraction.

    Mirrors the reference's ``IG.stdtss()`` formatting convention
    (``config/InfernGlobals.py:33-34``).
    """
    return f"{time.monotonic():.3f}"
