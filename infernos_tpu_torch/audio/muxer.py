"""Output muxer: per-track accumulation and N-track mixing.

Capability parity with ``Core/OutputMuxer.py``: ``TrackQueue`` coalesces
chunks, resamples to the output samplerate, emits fixed-size blocks and runs
``ASMarkerSentDoneCB.on_proc`` callbacks in-line when drained
(``Core/OutputMuxer.py:23-44``); ``MTMuxer`` mixes N tracks by zero-padded
mean (``:74-85``) so e.g. TTS speech and a signal-tone overlay coexist on one
RTP leg.

Host-side numpy (this runs on the pacer thread, per leg); the heavy DSP
(resampling) uses the shared polyphase path.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

import numpy as np

from .chunk import AudioChunk
from .markers import ASMarkerGeneric, ASMarkerSentDoneCB


class TrackQueue:
    """Single-track FIFO of audio samples + pending in-band markers."""

    def __init__(self, out_sr: int, qsize: int):
        self.out_sr = out_sr
        self.qsize = qsize
        self._buf = np.zeros(0, np.float32)
        self._markers: List[tuple] = []  # (sample_pos, marker)

    def put(self, item: Union[AudioChunk, ASMarkerGeneric]) -> None:
        if isinstance(item, ASMarkerGeneric):
            self._markers.append((len(self._buf), item))
            return
        chunk = item.resample(self.out_sr)
        self._buf = np.concatenate([self._buf, chunk.audio])

    def get(self, flush: bool = False) -> Optional[np.ndarray]:
        """Emit one fixed ``qsize`` block, or None if not enough buffered.

        ``flush=True`` (the pacer's idle tick, reference ``mix.idle()``,
        ``RTP/RTPOutputWorker.py:97``) pads a partial tail block with silence
        so stream ends drain instead of sticking below the block size.
        Markers positioned inside the emitted span fire now (the pacer has
        reached them).
        """
        if len(self._buf) < self.qsize:
            if not flush or (len(self._buf) == 0 and not self._markers):
                return None
            if len(self._buf) == 0 and self._markers:
                # marker-only drain (reference fires callbacks on drain,
                # ``Core/OutputMuxer.py:37-44``)
                for _, m in self._markers:
                    if isinstance(m, ASMarkerSentDoneCB):
                        m.on_proc()
                self._markers.clear()
                return None
            pad = np.zeros(self.qsize - len(self._buf), np.float32)
            self._buf = np.concatenate([self._buf, pad])
        out, self._buf = self._buf[: self.qsize], self._buf[self.qsize :]
        still: List[tuple] = []
        for pos, m in self._markers:
            if pos <= self.qsize:
                if isinstance(m, ASMarkerSentDoneCB):
                    m.on_proc()
            else:
                still.append((pos - self.qsize, m))
        self._markers = still
        return out

    @property
    def buffered(self) -> int:
        return len(self._buf)


class MTMuxer:
    """Multi-track mixer: mean of zero-padded active tracks per block."""

    def __init__(self, out_sr: int, qsize: int):
        self.out_sr = out_sr
        self.qsize = qsize
        self.tracks: Dict[int, TrackQueue] = {}

    def put(self, item: Union[AudioChunk, ASMarkerGeneric]) -> None:
        tq = self.tracks.get(item.track_id)
        if tq is None:
            tq = self.tracks[item.track_id] = TrackQueue(self.out_sr, self.qsize)
        tq.put(item)

    def get(self, flush: bool = False) -> Optional[np.ndarray]:
        blocks = []
        for tq in self.tracks.values():
            b = tq.get(flush=flush)
            if b is not None:
                blocks.append(b)
        if not blocks:
            return None
        if len(blocks) == 1:
            return blocks[0]
        return np.mean(np.stack(blocks), axis=0)

    @property
    def buffered(self) -> int:
        return max((tq.buffered for tq in self.tracks.values()), default=0)
