"""Audio containers for the host-side media plane.

Capability parity with the reference's ``Core/AudioChunk.py``: an
``AudioChunk`` couples samples with a samplerate, a mixer ``track_id`` and an
``active`` (speech) flag; ``VadAudioChunk`` adds an absolute sample position
and gap-zero-filling append (``Core/AudioChunk.py:29-47``).

Host-side audio lives in **numpy float32**, not in tensors: device work
(resampling, mel) is batched over many sessions at once, and a single chunk
never owns device memory.
"""

from __future__ import annotations

import audioop  # stdlib (Python <= 3.12); used only for ad-hoc decode helpers
import io
import wave
from dataclasses import dataclass

import numpy as np

from .resample import resample as _resample

_URL_CACHE_MAX = 64


def _fetch_url_cached(url: str, timeout: float) -> bytes:
    """Bounded LRU over fetched URL bytes; http/https/file only (a daemon
    fed many distinct or hostile URLs must not grow memory or open
    arbitrary schemes)."""
    import urllib.parse
    import urllib.request

    scheme = urllib.parse.urlparse(url).scheme
    if scheme not in ("http", "https", "file"):
        raise ValueError(f"unsupported URL scheme: {scheme!r}")
    cached = _url_cache.get(url)
    if cached is not None:
        _url_cache.pop(url)
        _url_cache[url] = cached  # refresh LRU position
        return cached
    with urllib.request.urlopen(url, timeout=timeout) as r:
        data = r.read()
    _url_cache[url] = data
    while len(_url_cache) > _URL_CACHE_MAX:
        _url_cache.pop(next(iter(_url_cache)))
    return data


_url_cache: dict = {}


@dataclass
class AudioChunk:
    """A chunk of mono PCM audio as float32 in [-1, 1]."""

    audio: np.ndarray
    samplerate: int
    track_id: int = 0
    active: bool = True
    debug: bool = False

    def __post_init__(self) -> None:
        a = np.asarray(self.audio)
        if a.dtype != np.float32:
            a = a.astype(np.float32)
        if a.ndim != 1:
            a = a.reshape(-1)
        self.audio = a

    @property
    def duration(self) -> float:
        return len(self.audio) / self.samplerate

    def resample(self, sample_rate: int) -> "AudioChunk":
        """Resample in place to ``sample_rate`` (cached polyphase filters)."""
        if sample_rate != self.samplerate:
            self.audio = _resample(self.audio, self.samplerate, sample_rate)
            self.samplerate = sample_rate
        return self

    # -- WAV helpers (replaces the reference's soundfile/requests usage) ----
    def to_wav_bytes(self) -> bytes:
        buf = io.BytesIO()
        with wave.open(buf, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(self.samplerate)
            pcm = np.clip(self.audio * 32767.0, -32768, 32767).astype("<i2")
            w.writeframes(pcm.tobytes())
        return buf.getvalue()

    def save_wav(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(self.to_wav_bytes())

    @classmethod
    def from_wav_bytes(cls, data: bytes, **kw) -> "AudioChunk":
        with wave.open(io.BytesIO(data), "rb") as w:
            sr = w.getframerate()
            nch = w.getnchannels()
            sw = w.getsampwidth()
            raw = w.readframes(w.getnframes())
        if sw == 2:
            pcm = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32767.0
        elif sw == 1:
            pcm = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        else:
            pcm = np.frombuffer(audioop.lin2lin(raw, sw, 2), dtype="<i2").astype(np.float32) / 32767.0
        if nch > 1:
            pcm = pcm.reshape(-1, nch).mean(axis=1)
        return cls(pcm, sr, **kw)

    @classmethod
    def from_wav_file(cls, path: str, **kw) -> "AudioChunk":
        with open(path, "rb") as f:
            return cls.from_wav_bytes(f.read(), **kw)

    @classmethod
    def from_url(cls, url: str, timeout: float = 10.0, **kw) -> "AudioChunk":
        """Fetch + decode a WAV by URL (reference ``AudioChunkFromURL``,
        ``Core/AudioChunk.py:49-57``).  Schemes restricted to http/https/
        file; fetched bytes are cached in a bounded LRU (the reference wraps
        the chunk in ``ray.put`` for the same reuse).  Under zero egress this
        raises ``URLError`` for remote hosts -- callers that need
        guaranteed-offline signals synthesize them instead
        (``audio/signals.py``)."""
        return cls.from_wav_bytes(_fetch_url_cached(url, timeout), **kw)


@dataclass
class VadAudioChunk(AudioChunk):
    """Speech segment with an absolute sample position in the stream.

    ``append`` zero-fills any gap between the end of this chunk and the
    ``ipos`` of the appended one (reference ``Core/AudioChunk.py:36-47``),
    which is how consecutive VAD segments merge into one STT request.
    """

    ipos: int = 0

    def tpos(self) -> float:
        return self.ipos / self.samplerate

    def append(self, other: "VadAudioChunk") -> None:
        assert self.samplerate == other.samplerate
        gap = other.ipos - (self.ipos + len(self.audio))
        assert gap >= 0, (self.ipos, len(self.audio), other.ipos)
        if gap > 0:
            self.audio = np.concatenate(
                [self.audio, np.zeros(gap, np.float32), other.audio]
            )
        else:
            self.audio = np.concatenate([self.audio, other.audio])
