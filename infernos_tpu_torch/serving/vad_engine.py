"""VAD serving: per-channel windowing, speech segmentation, batched inference.

Capability parity with the reference's VAD stack:

- :class:`VADIterator` -- the hysteresis state machine of
  ``Core/VAD/SileroVADUtils.py:74-133``: trigger at ``threshold`` (0.5),
  release below ``threshold - 0.15`` after ``min_silence_ms`` (100),
  ``speech_pad_ms`` (30) padding on both edges;
- :class:`VADChannel` -- byte ingestion + active-segment accumulation with
  the 30 s Whisper split (``Core/VAD/SileroVAD.py:14-35,84-111``): emits
  ``VadAudioChunk`` speech segments via ``vad_chunk_in`` and every raw
  window + activity flag via ``audio_chunk_in``;
- :class:`VADWorker` -- the batched worker (batch <=200,
  ``Core/VAD/SileroVAD.py:39``) that coalesces all channels' windows into
  one model call per tick (one [B, W] device program -- the fused-ingest
  design of SURVEY.md section 7);
- :class:`ZlibVAD` -- the compression-ratio fallback of
  ``Core/VAD/ZlibVAD.py:20-52``.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np

from ..audio.chunk import AudioChunk, VadAudioChunk
from .batcher import BatchedWorker


@dataclass
class VADIterator:
    """Per-channel hysteresis segmentation over a stream of speech probs."""

    sample_rate: int = 8000
    threshold: float = 0.5
    min_silence_ms: int = 100
    speech_pad_ms: int = 30

    triggered: bool = False
    temp_end: int = 0
    current_sample: int = 0

    def __post_init__(self) -> None:
        self.min_silence_samples = self.sample_rate * self.min_silence_ms // 1000
        self.speech_pad_samples = self.sample_rate * self.speech_pad_ms // 1000

    def step(self, prob: float, window_size: int) -> Optional[dict]:
        """Feed one window's speech probability; returns {'start': s} /
        {'end': s} events in absolute samples, or None."""
        self.current_sample += window_size
        if prob >= self.threshold and self.temp_end:
            self.temp_end = 0
        if prob >= self.threshold and not self.triggered:
            self.triggered = True
            pad = self.speech_pad_samples if self.current_sample > window_size else 0
            return {"start": self.current_sample - pad - window_size}
        if prob < self.threshold - 0.15 and self.triggered:
            if not self.temp_end:
                self.temp_end = self.current_sample
            if self.current_sample - self.temp_end < self.min_silence_samples:
                return None
            end = self.temp_end + self.speech_pad_samples - window_size
            self.temp_end = 0
            self.triggered = False
            return {"end": end}
        return None


class VADChannel:
    """One RTP stream's VAD state: byte buffer, window cutter, segmenter."""

    def __init__(self, audio_chunk_in: Callable[[AudioChunk, bool], None],
                 vad_chunk_in: Callable[[VadAudioChunk], None],
                 codec, sample_rate: int = 8000, window: int = 768,
                 max_seconds: int = 30):
        self.audio_chunk_in = audio_chunk_in
        self.vad_chunk_in = vad_chunk_in
        self.codec = codec
        self.sample_rate = sample_rate
        self.window = window
        self.max_vad_frames = sample_rate * max_seconds
        self.vad_buffer = b""
        self.iter = VADIterator(sample_rate=sample_rate)
        self.active_start: Optional[int] = None
        self.active_buffer = np.zeros(0, np.float32)

    def rebind_codec(self, codec) -> None:
        """Swap the stream codec before any audio buffered (first-packet
        payload-type follow, ``media.ingest.RTPInStream._proc``).  The
        channel keeps feeding VAD at ``self.sample_rate`` -- ``decode``
        resamples wideband codecs (G.722 16 kHz) down to it."""
        assert not self.vad_buffer, "rebind_codec after audio buffered"
        self.codec = codec

    def ingest(self, worker: "VADWorker", payload: bytes) -> None:
        """Append codec payload bytes; enqueue full windows to the worker."""
        self.vad_buffer += payload
        while self.codec.e2d_frames(len(self.vad_buffer), self.sample_rate) >= self.window:
            need = self.codec.d2e_frames(self.window, self.sample_rate)
            audio = self.codec.decode(self.vad_buffer[:need], resample=True,
                                      sample_rate=self.sample_rate)
            self.vad_buffer = self.vad_buffer[need:]
            worker.infer((self, audio))

    def on_prob(self, audio: np.ndarray, prob: float) -> None:
        """Process one window's probability (runs on the worker thread)."""
        ev = self.iter.step(prob, len(audio))
        self.active_buffer = np.concatenate([self.active_buffer, audio])
        cur = self.iter.current_sample
        if ev and "start" in ev:
            assert self.active_start is None
            self.active_start = ev["start"]
            poff = cur - self.active_start
            poff = min(poff, len(self.active_buffer))
            self.active_buffer = self.active_buffer[-poff:]
        elif ev and "end" in ev:
            active_end = ev["end"]
            assert self.active_start is not None and active_end > self.active_start
            poff = cur - active_end
            seg = self.active_buffer[:-poff] if poff > 0 else self.active_buffer
            self.vad_chunk_in(
                VadAudioChunk(seg, self.sample_rate, ipos=self.active_start)
            )
            self.active_start = None
        if self.active_start is None:
            # keep only a short pre-roll while idle (reference keeps 2 windows)
            self.active_buffer = self.active_buffer[-self.window * 2 :]
        elif len(self.active_buffer) > self.max_vad_frames:
            # 30 s cap: flush a max-length segment and keep going (Whisper bound)
            seg = VadAudioChunk(self.active_buffer[: self.max_vad_frames],
                                self.sample_rate, ipos=self.active_start)
            self.active_buffer = self.active_buffer[self.max_vad_frames :]
            self.active_start += self.max_vad_frames
            if self.iter.temp_end and self.iter.temp_end < self.active_start:
                self.iter.temp_end = self.active_start
            self.vad_chunk_in(seg)
        self.audio_chunk_in(AudioChunk(audio, self.sample_rate),
                            self.active_start is not None)


class VADWorker(BatchedWorker):
    """Batched VAD inference over all live channels.

    ``model`` is any callable ``[B, W] -> probs [B]`` with per-channel reset
    (``NeuralVAD`` / ``EnergyVAD`` from ``models.vad``).  Same-channel items
    within one batch are deferred to preserve state ordering (reference
    de-dup, ``Core/VAD/SileroVAD.py:65-77``).
    """

    max_batch_size = 200
    # micro-batching window: staggered per-leg arrivals otherwise degrade
    # the greedy drain to batch~1 (one forward per window and leg); 8 ms
    # is invisible against the 96 ms VAD tick
    batch_wait_s = 0.008

    def __init__(self, model_factory: Callable[[int], object], window: int = 768):
        super().__init__(name="vad")
        self.window = window
        self._model_factory = model_factory
        self._model = None
        self._chan_slots: dict = {}

    def process_batch(self, wis: List[Tuple[VADChannel, np.ndarray]]) -> None:
        while wis:
            nbatch, seen, chans, auds = [], set(), [], []
            for ch, audio in wis:
                if id(ch) in seen:
                    nbatch.append((ch, audio))
                else:
                    seen.add(id(ch))
                    chans.append(ch)
                    auds.append(audio)
            wis = nbatch
            probs = self._run_model(chans, np.stack(auds))
            for ch, audio, prob in zip(chans, auds, probs):
                ch.on_prob(audio, float(prob))

    def _run_model(self, chans, windows: np.ndarray) -> np.ndarray:
        if self._model is None:
            self._model = self._model_factory(self.max_batch_size)
        # map channels to stable model-state slots
        idxs = []
        for ch in chans:
            slot = self._chan_slots.get(id(ch))
            if slot is None:
                used = set(self._chan_slots.values())
                slot = next((i for i in range(self.max_batch_size)
                             if i not in used), None)
                if slot is None:
                    raise RuntimeError(
                        "VAD model-state slots exhausted: streams must call "
                        "release() at teardown (RTPInStream.release)")
                self._chan_slots[id(ch)] = slot
                self._model.reset_channel(slot)
            idxs.append(slot)
        if getattr(self._model, "supports_slots", False):
            # run ONLY the occupied rows: a full-width [200, W] forward per
            # staggered arrival would cost many times the true batch
            return self._model(windows, slots=np.asarray(idxs))
        full = np.zeros((self.max_batch_size, self.window), np.float32)
        for i, slot in enumerate(idxs):
            full[slot] = windows[i]
        probs = self._model(full)
        return probs[idxs]

    def release_channel(self, ch: VADChannel) -> None:
        self._chan_slots.pop(id(ch), None)


class ZlibVAD:
    """Compression-ratio VAD fallback (no model): ratio < 0.6 == silence."""

    vad_duration = 0.1
    vad_threshold = 0.6
    activation_threshold = 5

    def __init__(self, input_sr: int = 8000):
        self.vad_frames = int(input_sr * self.vad_duration)
        self.max_vad_frames = input_sr * 30
        self.vad_buffer = b""
        self.chunk_buffer = b""
        self.ninactive = 0

    def ingest(self, data: bytes, vad_chunk_in: Callable[[bytes, bool], None]) -> Optional[bytes]:
        """Returns a completed utterance's bytes when an utterance ends."""
        self.vad_buffer += data
        if len(self.vad_buffer) < self.vad_frames:
            return None
        chunk = self.vad_buffer[: self.vad_frames]
        self.vad_buffer = self.vad_buffer[self.vad_frames :]
        ratio = len(zlib.compress(chunk)) / len(chunk)
        active = ratio >= self.vad_threshold
        vad_chunk_in(chunk, active)
        if active:
            self.ninactive = 0
            self.chunk_buffer += chunk
            if len(self.chunk_buffer) >= self.max_vad_frames:
                out = self.chunk_buffer[: self.max_vad_frames]
                self.chunk_buffer = self.chunk_buffer[self.max_vad_frames :]
                return out
            return None
        if self.ninactive > self.activation_threshold:
            out = self.chunk_buffer[: -self.vad_frames * self.activation_threshold]
            self.chunk_buffer = b""
            self.ninactive = 0
            return out if len(out) >= self.vad_frames * self.activation_threshold else None
        self.chunk_buffer += chunk
        self.ninactive += 1
        return None
