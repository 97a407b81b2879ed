"""Codec base class.

Capability parity with the reference's ``Core/Codecs/GenCodec.py:1-13``:
sample rate, RTP clock rate, payload type, encoding name, and the ``rtpmap``
SDP helper.
"""

from __future__ import annotations

import numpy as np


class GenCodec:
    srate: int = 8000  # sample rate
    crate: int = 8000  # RTP clock rate
    ptype: int  # RTP payload type
    ename: str  # SDP encoding name

    @classmethod
    def rtpmap(cls) -> str:
        return f"rtpmap:{cls.ptype} {cls.ename}/{cls.crate}"

    # -- interface -----------------------------------------------------------
    def encode(self, audio: np.ndarray) -> bytes:
        """float32 [-1,1] at ``self.srate`` -> payload bytes."""
        raise NotImplementedError

    def decode(self, payload: bytes) -> np.ndarray:
        """payload bytes -> float32 [-1,1] at ``self.srate``."""
        raise NotImplementedError

    def silence(self, nframes: int) -> bytes:
        """Payload bytes encoding ``nframes`` encoded-domain frames of silence."""
        raise NotImplementedError

    # Encoded-frame <-> decoded-sample conversions (G.722 compresses 2:1;
    # reference ``Core/Codecs/G711.py:61-67``, ``G722.py:50-56``).
    def e2d_frames(self, enframes: int, out_srate: int | None = None) -> int:
        out_srate = out_srate or self.srate
        assert out_srate % self.srate == 0
        return enframes * out_srate // self.srate

    def d2e_frames(self, dnframes: int, in_srate: int | None = None) -> int:
        in_srate = in_srate or self.srate
        assert in_srate % self.srate == 0
        return dnframes * self.srate // in_srate
