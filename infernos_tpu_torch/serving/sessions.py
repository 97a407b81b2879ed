"""Per-call session objects over the serving engines.

Capability parity with the reference's ``Cluster/STTSession.py`` and
``Cluster/TTSSession.py``:

- :class:`STTSession` serializes one stream's requests (busy flag + pending
  list), merges consecutive VAD chunks into one request when the combined
  span stays under the engine bound (``STTSession.py:84-92``), carries a
  rolling token context (``:50-56``), and passes ``STTSentinel('flush')``
  through when no audio is queued (``:99-100``) -- end-of-utterance
  detection for the apps.
- :class:`TTSSession` chains multi-sentence requests by re-enqueueing the
  remainder from ``done_cb`` (``TTSSession.py:104-125``), converts engine
  chunks to ``AudioChunk``/markers (``TTSSndDispatch``, ``:70-85``), and
  cancels by flag + end marker (``stop_saying``, ``:62-68,127-134``).
"""

from __future__ import annotations

import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..audio.chunk import AudioChunk, VadAudioChunk
from ..audio.markers import ASMarkerNewSent, ASMarkerSentDoneCB
from .stt_engine import STTRequest as EngineSTTRequest
from .stt_engine import STTResult


@dataclass
class STTRequest:
    """App-facing request: a (VAD) chunk plus language/mode."""

    chunk: AudioChunk
    text_cb: Callable[[STTResult], None]
    lang: str = "en"
    mode: str = "transcribe"
    timestamps: bool = False
    max_ns_prob: float = 0.5
    stime: float = field(default_factory=time.monotonic)


@dataclass
class STTSentinel:
    """In-band control item; delivered when queue drains of audio."""

    signal: str
    text_cb: Callable[["STTSentinel"], None]
    stime: float = field(default_factory=time.monotonic)


class STTSession:
    """Serialize one stream's requests into the engine; merge VAD chunks."""

    max_chunk_duration: float = 32.0  # reference InfernSTTWorker.py:18
    sample_rate: int = 16000

    def __init__(self, engine, keep_context: bool = False):
        self.id = uuid.uuid4()
        self.engine = engine
        self.context: Optional[List[int]] = [] if keep_context else None
        # RLock: engines may complete a request synchronously (inline
        # test engines, cache hits), re-entering _on_result from submit
        self.lock = threading.RLock()
        self.busy = False
        self.pending: List[Union[STTRequest, STTSentinel]] = []
        self.closed = False

    def stop(self) -> None:
        with self.lock:
            self.closed = True
            self.pending.clear()

    def soundin(self, req: Union[STTRequest, STTSentinel]) -> None:
        flushes: List[STTSentinel] = []
        with self.lock:
            if self.closed:
                return
            self.pending.append(req)
            if self.busy:
                return
            self.busy = True
            self._pump_locked(flushes)
        for s in flushes:
            s.text_cb(s)

    def _pump_locked(self, flushes: List[STTSentinel]) -> None:
        while self.pending:
            req = self.pending.pop(0)
            if isinstance(req, STTRequest):
                # merge following VAD chunks while combined span fits
                if isinstance(req.chunk, VadAudioChunk):
                    while True:
                        nxt = next((r for r in self.pending
                                    if isinstance(r, STTRequest)), None)
                        if nxt is None or not isinstance(nxt.chunk, VadAudioChunk):
                            break
                        ca, cb = req.chunk, nxt.chunk
                        span = cb.tpos() + cb.duration - ca.tpos()
                        if span >= self.max_chunk_duration:
                            break
                        ca.append(cb)
                        self.pending.remove(nxt)
                chunk = req.chunk.resample(self.sample_rate)
                ereq = EngineSTTRequest(
                    audio=chunk.audio,
                    text_cb=lambda res, r=req: self._on_result(r, res),
                    lang=req.lang,
                    mode=req.mode,
                    timestamps=req.timestamps,
                    context=(np.asarray(self.context, np.int64)
                             if self.context else None),
                    max_ns_prob=req.max_ns_prob,
                )
                self.engine.submit(ereq)
                return  # wait for result before next pending item
            # sentinel: deliver once no audio remains queued ahead of it
            if all(isinstance(r, STTRequest) for r in self.pending):
                flushes.append(req)
        self.busy = False

    def _on_result(self, req: STTRequest, res: STTResult) -> None:
        if self.context is not None:
            self.context.extend(res.tokens)
            self.context = self.context[-self.engine.ecfg.context_tokens:]
        flushes: List[STTSentinel] = []
        with self.lock:
            if self.closed:
                return
            self._pump_locked(flushes)
        req.text_cb(res)
        for s in flushes:
            s.text_cb(s)


@dataclass
class TTSRequest:
    """Say one or more sentences with an optional per-utterance done callback."""

    text: Union[str, Sequence[str]]
    speaker_id: Optional[int] = None
    done_cb: Optional[Callable[[], None]] = None


class TTSSoundDispatch:
    """Bridges engine audio chunks to a soundout callable as AudioChunk /
    markers; ``None`` EOS becomes a sentence marker (+done callback)."""

    def __init__(self, soundout: Callable, output_sr: int,
                 done_cb: Optional[Callable[[], None]],
                 norm_rms: float = 0.0):
        self.id = uuid.uuid4()
        self.soundout = soundout
        self.output_sr = output_sr
        self.done_cb = done_cb
        self.cancelled = False
        self.cleanup_cb: Optional[Callable[[], None]] = None
        # per-say loudness normalization (TTSEngineConfig.output_norm_rms):
        # gain locks on the first energetic chunk so every chunk of one
        # utterance scales coherently
        self.norm_rms = norm_rms
        self._gain: Optional[float] = None

    def cancel(self) -> None:
        self.cancelled = True
        self._emit_end()

    def _emit_end(self) -> None:
        marker = (ASMarkerNewSent() if self.done_cb is None
                  else ASMarkerSentDoneCB(self.done_cb, sync=True))
        self.soundout(marker)
        if self.cleanup_cb is not None:
            self.cleanup_cb()

    def __call__(self, audio: Optional[np.ndarray]) -> None:
        if self.cancelled:
            return
        if audio is None:
            self._emit_end()
            return
        if self.norm_rms > 0.0:
            audio = np.asarray(audio, np.float32)
            if self._gain is None:
                rms = float(np.sqrt(np.mean(np.square(audio)))) if len(audio) else 0.0
                if rms > 1e-7:  # leading silence passes through unscaled
                    self._gain = self.norm_rms / rms
            if self._gain is not None:
                audio = np.clip(audio * self._gain, -0.95, 0.95)
        self.soundout(AudioChunk(audio, self.output_sr, track_id=0))


class TTSSession:
    """Multi-sentence say queue over the streaming TTS engine."""

    def __init__(self, engine, tokenize: Callable[[str], np.ndarray],
                 speaker_bank=None):
        self.id = uuid.uuid4()
        self.engine = engine
        self.tokenize = tokenize
        self.speaker_bank = speaker_bank
        self.soundout: Optional[Callable] = None
        self.active: Dict[uuid.UUID, Tuple[TTSSoundDispatch, int]] = {}

    def start(self, soundout: Callable) -> None:
        self.soundout = soundout

    def say(self, req: TTSRequest) -> uuid.UUID:
        assert self.soundout is not None, "start() first"
        texts = [req.text] if isinstance(req.text, str) else list(req.text)
        text, rest = texts[0], texts[1:]
        done_cb = req.done_cb
        if rest:
            done_cb = lambda: self.say(TTSRequest(rest, req.speaker_id, req.done_cb))
        if self.speaker_bank is not None:
            if req.speaker_id is None:
                req.speaker_id = self.speaker_bank.rand_id()
            spk = self.speaker_bank.get(req.speaker_id)
        else:
            spk = np.zeros(self.engine.cfg.speaker_embedding_dim, np.float32)
        disp = TTSSoundDispatch(self.soundout, self.engine.ecfg.sample_rate,
                                done_cb,
                                norm_rms=getattr(self.engine.ecfg,
                                                 "output_norm_rms", 0.0))
        disp.cleanup_cb = lambda: self.active.pop(disp.id, None)
        sid = self.engine.start_session(self.tokenize(text), spk, disp)
        self.active[disp.id] = (disp, sid)
        return disp.id

    def stop_saying(self, say_id: uuid.UUID) -> bool:
        ent = self.active.get(say_id)
        if ent is None:
            return False
        disp, sid = ent
        self.engine.cancel_session(sid)
        disp.cancel()
        return True

    def end(self) -> None:
        for disp, sid in list(self.active.values()):
            self.engine.cancel_session(sid)
        self.active.clear()


# -- LLM session ---------------------------------------------------------------


@dataclass
class LLMResult:
    text: str
    is_final: bool
    req_id: int


class LLMSession:
    """Chat-context session over the LLM engine.

    Capability parity with ``Cluster/LLMSession.py``: a chat context list
    with same-role merge (``:43-49``); ``textin`` templates the context and
    submits; ``textout`` auto-appends the assistant turn unless
    ``auto_ctx_add=False`` (``:61-66``).
    """

    def __init__(self, engine, tokenize: Callable[[str], np.ndarray],
                 system_prompt: Optional[str] = None):
        self.id = uuid.uuid4()
        self.engine = engine
        self.tokenize = tokenize
        self.context: List[dict] = []
        if system_prompt:
            self.context.append({"role": "system", "content": system_prompt})
        self._next_req = 0

    def context_add(self, content: str, role: str = "user") -> None:
        if self.context and self.context[-1]["role"] == role:
            self.context[-1]["content"] += "\n" + content
        else:
            self.context.append({"role": role, "content": content})

    def textin(self, text: str,
               result_cb: Callable[[LLMResult], None],
               auto_ctx_add: bool = True,
               max_new_tokens: Optional[int] = None,
               req_id: Optional[int] = None) -> int:
        from .llm_engine import LLMRequest, apply_chat_template

        self.context_add(text, role="user")
        if req_id is None:
            req_id = self._next_req
        # callers that pass their own ids (fire-and-forget actor calls that
        # cannot wait for the return value) must never collide with
        # auto-assigned ones
        self._next_req = max(self._next_req, req_id) + 1
        parts: List[str] = []

        def sentence_cb(sent: str, is_final: bool) -> None:
            if sent:
                parts.append(sent)
            if is_final and auto_ctx_add:
                full = " ".join(parts)
                if full:
                    self.context_add(full, role="assistant")
            result_cb(LLMResult(sent, is_final, req_id))

        prompt = apply_chat_template(self.context)
        self.engine.submit(LLMRequest(
            prompt_ids=self.tokenize(prompt),
            sentence_cb=sentence_cb,
            max_new_tokens=max_new_tokens,
        ))
        return req_id
