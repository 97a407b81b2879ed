"""G.722 wideband ADPCM codec (64 kbit/s), RTP payload type 9.

Capability parity: the reference wraps a C extension module
(``Core/Codecs/G722.py:1,18,25,31``) configured for an 8 kHz convenience mode.
We implement the full ITU-T G.722 algorithm -- 24-tap QMF analysis/synthesis
plus per-band ADPCM with the standard adaptive predictor (two poles, six
zeros) -- natively: this file is the behavioural reference and test oracle;
``native/`` carries the C++ port used on the media-plane hot path.

Wire format is standard G.722 mode 1: one octet per 16 kHz sample pair
(6-bit low band | 2-bit high band), RTP clock rate 8000 per RFC 3551.  Audio
side operates at 16 kHz (true wideband -- a capability step over the
reference's 8 kHz-only mode).
"""

from __future__ import annotations

import numpy as np

from ..chunk import AudioChunk
from .base import GenCodec

# ITU-T G.722 constant tables (public standard constants).
_Q6 = (0, 35, 72, 110, 150, 190, 233, 276, 323, 370, 422, 473, 530, 587,
       650, 714, 786, 858, 940, 1023, 1121, 1219, 1339, 1458, 1612, 1765,
       1980, 2195, 2557, 2919)
_ILN = (0, 63, 62, 31, 30, 29, 28, 27, 26, 25, 24, 23, 22, 21, 20, 19, 18,
        17, 16, 15, 14, 13, 12, 11, 10, 9, 8, 7, 6, 5, 4, 0)
_ILP = (0, 61, 60, 59, 58, 57, 56, 55, 54, 53, 52, 51, 50, 49, 48, 47, 46,
        45, 44, 43, 42, 41, 40, 39, 38, 37, 36, 35, 34, 33, 32, 0)
_WL = (-60, -30, 58, 172, 334, 538, 1198, 3042)
_RL42 = (0, 7, 6, 5, 4, 3, 2, 1, 7, 6, 5, 4, 3, 2, 1, 0)
_ILB = (2048, 2093, 2139, 2186, 2233, 2282, 2332, 2383, 2435, 2489, 2543,
        2599, 2656, 2714, 2774, 2834, 2896, 2960, 3025, 3091, 3158, 3228,
        3298, 3371, 3444, 3520, 3597, 3676, 3756, 3838, 3922, 4008)
_QM2 = (-7408, -1616, 7408, 1616)
_QM4 = (0, -20456, -12896, -8968, -6288, -4240, -2584, -1200,
        20456, 12896, 8968, 6288, 4240, 2584, 1200, 0)
_QM6 = (-136, -136, -136, -136, -24808, -21904, -19008, -16704, -14984,
        -13512, -12280, -11192, -10232, -9360, -8576, -7856, -7192, -6576,
        -6000, -5456, -4944, -4464, -4008, -3576, -3168, -2776, -2400,
        -2032, -1688, -1360, -1040, -728, 24808, 21904, 19008, 16704,
        14984, 13512, 12280, 11192, 10232, 9360, 8576, 7856, 7192, 6576,
        6000, 5456, 4944, 4464, 4008, 3576, 3168, 2776, 2400, 2032, 1688,
        1360, 1040, 728, 432, 136, -432, -136)
_IHN = (0, 1, 0)
_IHP = (0, 3, 2)
_WH = (0, -214, 798)
_RH2 = (2, 1, 2, 1)
_QMF = (3, -11, 12, 32, -210, 951, 3876, -805, 362, -156, 53, -11)


def _sat(x: int) -> int:
    return 32767 if x > 32767 else (-32768 if x < -32768 else x)


class _Band:
    """Per-band ADPCM state: adaptive predictor + scale factor."""

    __slots__ = ("s", "sp", "sz", "r", "a", "ap", "p", "d", "b", "bp", "sg",
                 "nb", "det")

    def __init__(self, det: int):
        self.s = self.sp = self.sz = 0
        self.r = [0, 0, 0]
        self.a = [0, 0, 0]
        self.ap = [0, 0, 0]
        self.p = [0, 0, 0]
        self.d = [0] * 7
        self.b = [0] * 7
        self.bp = [0] * 7
        self.sg = [0] * 7
        self.nb = 0
        self.det = det

    def block4(self, d: int) -> None:
        """Adaptive predictor update (ITU-T G.722 block 4, both bands)."""
        self.d[0] = d
        self.r[0] = _sat(self.s + d)
        self.p[0] = _sat(self.sz + d)
        # Pole section: adapt a2, a1
        for i in range(3):
            self.sg[i] = self.p[i] >> 15
        wd1 = _sat(self.a[1] << 2)
        wd2 = -wd1 if self.sg[0] == self.sg[1] else wd1
        if wd2 > 32767:
            wd2 = 32767
        wd3 = (wd2 >> 7) + (128 if self.sg[0] == self.sg[2] else -128)
        wd3 += (self.a[2] * 32512) >> 15
        if wd3 > 12288:
            wd3 = 12288
        elif wd3 < -12288:
            wd3 = -12288
        self.ap[2] = wd3
        self.sg[0] = self.p[0] >> 15
        self.sg[1] = self.p[1] >> 15
        wd1 = 192 if self.sg[0] == self.sg[1] else -192
        wd2 = (self.a[1] * 32640) >> 15
        self.ap[1] = _sat(wd1 + wd2)
        wd3 = _sat(15360 - self.ap[2])
        if self.ap[1] > wd3:
            self.ap[1] = wd3
        elif self.ap[1] < -wd3:
            self.ap[1] = -wd3
        # Zero section: adapt b1..b6
        wd1 = 0 if d == 0 else 128
        self.sg[0] = d >> 15
        for i in range(1, 7):
            self.sg[i] = self.d[i] >> 15
            wd2 = wd1 if self.sg[i] == self.sg[0] else -wd1
            wd3 = (self.b[i] * 32640) >> 15
            self.bp[i] = _sat(wd2 + wd3)
        # Delay-line shifts
        for i in range(6, 0, -1):
            self.d[i] = self.d[i - 1]
            self.b[i] = self.bp[i]
        for i in range(2, 0, -1):
            self.r[i] = self.r[i - 1]
            self.p[i] = self.p[i - 1]
            self.a[i] = self.ap[i]
        # FILTEZ / FILTEP / PREDIC
        sz = 0
        for i in range(6, 0, -1):
            wd1 = _sat(self.d[i] + self.d[i])
            sz += (self.b[i] * wd1) >> 15
        self.sz = _sat(sz)
        wd1 = _sat(self.r[1] + self.r[1])
        sp = (self.a[1] * wd1) >> 15
        wd1 = _sat(self.r[2] + self.r[2])
        sp += (self.a[2] * wd1) >> 15
        self.sp = _sat(sp)
        self.s = _sat(self.sp + self.sz)

    def _scale(self, shift_base: int) -> None:
        wd1 = (self.nb >> 6) & 31
        wd2 = shift_base - (self.nb >> 11)
        wd3 = _ILB[wd1] << -wd2 if wd2 < 0 else _ILB[wd1] >> wd2
        self.det = wd3 << 2

    def logscl(self, il4: int, nb_max: int) -> None:
        wd = (self.nb * 127) >> 7
        self.nb = wd + _WL[il4]
        if self.nb < 0:
            self.nb = 0
        elif self.nb > nb_max:
            self.nb = nb_max
        self._scale(8)

    def logsch(self, ih2: int) -> None:
        wd = (self.nb * 127) >> 7
        self.nb = wd + _WH[ih2]
        if self.nb < 0:
            self.nb = 0
        elif self.nb > 22528:
            self.nb = 22528
        self._scale(10)


class G722State:
    """Full codec state: two ADPCM bands + 24-tap QMF delay line."""

    def __init__(self) -> None:
        self.band = [_Band(det=32), _Band(det=8)]
        self.x = [0] * 24

    # -- encode ------------------------------------------------------------
    def encode(self, pcm: np.ndarray) -> bytes:
        """int16 PCM @16 kHz (even length) -> one byte per sample pair."""
        out = bytearray()
        x = self.x
        lo, hi = self.band
        for j in range(0, len(pcm) - 1, 2):
            # QMF analysis
            x[:22] = x[2:]
            x[22] = int(pcm[j])
            x[23] = int(pcm[j + 1])
            sumodd = sum(x[2 * i] * _QMF[i] for i in range(12))
            sumeven = sum(x[2 * i + 1] * _QMF[11 - i] for i in range(12))
            xlow = (sumeven + sumodd) >> 14
            xhigh = (sumeven - sumodd) >> 14
            # Low band: 6-bit quantize
            el = _sat(xlow - lo.s)
            wd = el if el >= 0 else -(el + 1)
            ilow_i = 30
            for i in range(1, 30):
                if wd < (_Q6[i] * lo.det) >> 12:
                    ilow_i = i
                    break
            ilow = _ILN[ilow_i] if el < 0 else _ILP[ilow_i]
            ril = ilow >> 2
            dlowt = (lo.det * _QM4[ril]) >> 15
            lo.logscl(_RL42[ril], 18432)
            lo.block4(dlowt)
            # High band: 2-bit quantize
            eh = _sat(xhigh - hi.s)
            wd = eh if eh >= 0 else -(eh + 1)
            mih = 2 if wd >= ((564 * hi.det) >> 12) else 1
            ihigh = _IHN[mih] if eh < 0 else _IHP[mih]
            dhigh = (hi.det * _QM2[ihigh]) >> 15
            hi.logsch(_RH2[ihigh])
            hi.block4(dhigh)
            out.append((ihigh << 6) | ilow)
        return bytes(out)

    # -- decode ------------------------------------------------------------
    def decode(self, payload: bytes) -> np.ndarray:
        """G.722 octets -> int16 PCM @16 kHz (2 samples per octet)."""
        out = np.empty(2 * len(payload), dtype=np.int16)
        x = self.x
        lo, hi = self.band
        k = 0
        for code in payload:
            ilow = code & 0x3F
            ihigh = (code >> 6) & 0x03
            # Low band reconstruct (mode 1: 6-bit inverse quantizer)
            wd2 = _QM6[ilow]
            rlow = lo.s + ((lo.det * wd2) >> 15)
            if rlow > 16383:
                rlow = 16383
            elif rlow < -16384:
                rlow = -16384
            ril = ilow >> 2
            dlowt = (lo.det * _QM4[ril]) >> 15
            lo.logscl(_RL42[ril], 18432)
            lo.block4(dlowt)
            # High band reconstruct
            dhigh = (hi.det * _QM2[ihigh]) >> 15
            rhigh = dhigh + hi.s
            if rhigh > 16383:
                rhigh = 16383
            elif rhigh < -16384:
                rhigh = -16384
            hi.logsch(_RH2[ihigh])
            hi.block4(dhigh)
            # QMF synthesis
            x[:22] = x[2:]
            x[22] = rlow + rhigh
            x[23] = rlow - rhigh
            xout2 = sum(x[2 * i] * _QMF[i] for i in range(12))
            xout1 = sum(x[2 * i + 1] * _QMF[11 - i] for i in range(12))
            out[k] = _sat(xout1 >> 11)
            out[k + 1] = _sat(xout2 >> 11)
            k += 2
        return out


def _native_backend():
    """The C++ engine (bit-exact vs this file's oracle) when buildable."""
    from ...media import native  # local import: avoid cycles at package init
    if native.available():
        return native.NativeG722
    return None


class G722Codec(GenCodec):
    """Stateful G.722 codec instance (one per stream direction)."""

    srate = 16000
    crate = 8000  # RFC 3551: G722 RTP clock rate is 8000 despite 16 kHz audio
    ptype = 9
    ename = "G722"

    def __init__(self) -> None:
        nb = _native_backend()
        if nb is not None:
            self._enc_state = nb()
            self._dec_state = nb()
        else:
            self._enc_state = G722State()
            self._dec_state = G722State()

    def encode(self, audio: np.ndarray) -> bytes:
        pcm = np.clip(np.asarray(audio) * 32767.0, -32768, 32767).astype(np.int16)
        return self._enc_state.encode(pcm)

    def decode(self, payload: bytes, resample: bool = False, sample_rate: int = 16000) -> np.ndarray:
        pcm = self._dec_state.decode(payload)
        pcm = np.asarray(pcm)
        audio = pcm.astype(np.float32) / 32767.0
        if resample and sample_rate != self.srate:
            return AudioChunk(audio, self.srate).resample(sample_rate).audio
        return audio

    def silence(self, nframes: int) -> bytes:
        return self.encode(np.zeros(self.e2d_frames(nframes), np.float32))

    def e2d_frames(self, enframes: int, out_srate: int | None = None) -> int:
        out_srate = out_srate or self.srate
        return enframes * 2 * out_srate // self.srate

    def d2e_frames(self, dnframes: int, in_srate: int | None = None) -> int:
        in_srate = in_srate or self.srate
        return dnframes * self.srate // (2 * in_srate)
