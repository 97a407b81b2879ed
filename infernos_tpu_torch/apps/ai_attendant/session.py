"""AIAttendant call session: phone call <-> LLM conversation.

Capability parity with ``Apps/AIAttendant/AIASession.py``:

- single leg, auto-answer (``:77``);
- STT wiring: VAD speech segments -> STT requests; raw-audio activity watch
  fires a flush sentinel after 2 s of silence (``:30-43``) -- utterance
  aggregation;
- ``text_in`` buffers STT results until the sentinel, then sends the joined
  utterance to the LLM (``:121-145``);
- **barge-in**: new speech while TTS is speaking truncates the say-queue,
  stops the current utterance, and injects ``<sentence interrupted>`` into
  the LLM context (``:133-138``);
- ``text_out`` ignores stale request ids and honors ``<nothingtosay>``
  (``:147-154``); replies are sentence-split, number-normalized, and played
  through a serialized TTS queue (``:155-185``);
- call metadata is injected as the first LLM turn (``:109-112``).

Port of ``infernos_tpu/apps/ai_attendant/session.py``.  It also logs, at
DEBUG, each VAD segment, STT result, LLM reply and say started and played
out, as ``LTSession`` does, so a driver can tell when a reply is over.
"""

from __future__ import annotations

import time
import uuid as uuid_mod
from typing import List, Optional

from ...audio.chunk import AudioChunk, VadAudioChunk
from ...media.ingest import AudioInput
from ...serving.sessions import STTRequest, STTSentinel, TTSRequest
from ...t2t import NumbersToWords, regroup_sentences, sent_split
from ...utils.logging import get_logger

log = get_logger("apps.aia.session")

NOTHING_TO_SAY = "<nothingtosay>"
INTERRUPTED = "<sentence interrupted>"
SILENCE_FLUSH_S = 2.0


class _PendingSay:
    """Placeholder for ``saying`` while the tts_session_say ask is in
    flight; the real say_id arrives via ``say_started``."""


class AIASession:
    """One attendant call.  All methods run on the AIAActor mailbox."""

    def __init__(self, actor, offer) -> None:
        self.id = uuid_mod.uuid4()
        self.actor = actor
        self.profile = actor.profile
        self.n2w = NumbersToWords(self.profile.tts_lang)
        # -- SIP/RTP: auto-answer --------------------------------------------
        res = offer.accept(disc_cb=lambda: actor.handle.call("sess_term", self.id))
        self.sip_sess_id = res.sip_sess_id
        self.rtp_sess_id = res.rtp_sess_id
        # -- model sessions ---------------------------------------------------
        self.stt_sess_id = actor.stt_actr.ask_sync("new_stt_session", True)
        self.llm_sess_id = actor.llm_actr.ask_sync(
            "new_llm_session", self.profile.llm_prompt)
        self.tts_sess_id = actor.tts_actr.ask_sync("new_tts_session")
        actor.tts_actr.ask_sync(
            "tts_session_start", self.tts_sess_id,
            lambda chunk: actor.rtp_actr.call("rtp_session_soundout",
                                              self.rtp_sess_id, chunk))
        self.speaker_id = actor.tts_actr.ask_sync("get_rand_voice_id")
        # call metadata as the first LLM turn (reference :109-112)
        info = offer.sess_info
        actor.llm_actr.call(
            "llm_session_context_add", self.llm_sess_id,
            f"<incoming call from {info.from_name or info.from_number} "
            f"({info.from_number})>", "user")
        # -- state -------------------------------------------------------------
        self.text_buffer: List[str] = []
        self.say_queue: List[str] = []
        self.saying = None  # None | pending token | resolved say_id (UUID)
        self._stop_on_start = set()  # barge-ins hit while a say_id was pending
        self.last_active = time.monotonic()
        self.flush_armed = False
        self.live_req_id: Optional[int] = None
        # session-owned req ids passed INTO textin, so the fire-and-forget
        # actor call (blocking the mailbox on an ask_sync serializes every
        # session behind one LLM round-trip -- round-4 ramp wedge) cannot
        # desync from the engine-side counter
        self._next_llm_req = 0
        self.closed = False
        # -- media wiring (callbacks hop to the actor mailbox) -----------------
        actor.rtp_actr.call(
            "rtp_session_connect", self.rtp_sess_id,
            AudioInput(
                audio_in=lambda chunk: actor.handle.call("audio_in", self.id, chunk),
                vad_chunk_in=lambda chunk: actor.handle.call("vad_chunk_in",
                                                             self.id, chunk),
            ))
        log.info("AIASession %s started (from %s)", self.id, info.from_number)

    # -- inbound audio ----------------------------------------------------------
    def vad_chunk_in(self, chunk: VadAudioChunk) -> None:
        if self.closed:
            return
        self.flush_armed = True
        log.debug("AIASession %s: vad chunk %d samples", self.id, len(chunk.audio))
        self.actor.stt_actr.call(
            "stt_session_soundin", self.stt_sess_id,
            STTRequest(chunk=chunk, lang=self.profile.stt_lang,
                       text_cb=lambda res: self.actor.handle.call(
                           "text_in", self.id, res)))

    def audio_in(self, chunk: AudioChunk) -> None:
        if self.closed:
            return
        now = time.monotonic()
        if chunk.active:
            self.last_active = now
            if self.saying is not None or self.say_queue:
                self._barge_in()
        elif (self.flush_armed and self.text_buffer
              and now - self.last_active > SILENCE_FLUSH_S):
            self.flush_armed = False
            self.actor.stt_actr.call(
                "stt_session_soundin", self.stt_sess_id,
                STTSentinel("flush", text_cb=lambda s: self.actor.handle.call(
                    "stt_flush", self.id)))

    def _barge_in(self) -> None:
        """Caller spoke while we were talking (reference :133-138)."""
        self.say_queue.clear()
        if self.saying is not None:
            if isinstance(self.saying, _PendingSay):
                # the say's id has not resolved yet: stop it the moment
                # say_started delivers it
                self._stop_on_start.add(self.saying)
            else:
                self.actor.tts_actr.call("tts_session_stop_saying",
                                         self.tts_sess_id, self.saying)
            self.saying = None
            self.actor.llm_actr.call("llm_session_context_add",
                                     self.llm_sess_id, INTERRUPTED, "user")

    # -- STT results --------------------------------------------------------------
    def text_in(self, res) -> None:
        if self.closed:
            return
        log.debug("AIASession %s: stt %r (ns_prob %.2f)", self.id, res.text,
                  res.no_speech_prob)
        text = res.text.strip()
        if res.no_speech_prob > 0.5 or not text:
            # unaudible-segment protocol (reference :126-130): short garbage
            # is dropped; long unintelligible audio is reported to the LLM
            if res.duration < 5.0:
                return
            text = (f"<unaudible duration={res.duration:.1f} "
                    f"no_speech_probability={res.no_speech_prob:.2f}>")
        self.text_buffer.append(text)

    def stt_flush(self, *_) -> None:
        if self.closed or not self.text_buffer:
            return
        utterance = " ".join(self.text_buffer)
        self.text_buffer.clear()
        # fire-and-forget; the session OWNS the req id and passes it in
        self.live_req_id = self._next_llm_req
        self._next_llm_req += 1
        self.actor.llm_actr.call(
            "llm_session_textin", self.llm_sess_id, utterance,
            lambda r: self.actor.handle.call("text_out", self.id, r),
            req_id=self.live_req_id)

    # -- LLM results ----------------------------------------------------------------
    def text_out(self, r) -> None:
        if self.closed:
            return
        if r.req_id != self.live_req_id:  # stale (reference :147-150)
            return
        log.debug("AIASession %s: llm %r (final %s)", self.id, r.text, r.is_final)
        text = r.text.strip()
        if not text or NOTHING_TO_SAY in text:
            return
        text = self.actor.translate(text)
        for group in regroup_sentences(sent_split(self.n2w(text))):
            self.say_queue.append(group)
        self._pump_say()

    def _pump_say(self) -> None:
        """Start the next queued utterance WITHOUT blocking the actor mailbox
        (see LTSession._pump_say); the say_id resolves via ``say_started``."""
        if self.saying is not None or not self.say_queue:
            return
        text = self.say_queue.pop(0)
        log.debug("AIASession %s: say %r", self.id, text)
        token = _PendingSay()
        self.saying = token
        fut = self.actor.tts_actr.ask(
            "tts_session_say", self.tts_sess_id,
            TTSRequest(text, speaker_id=self.speaker_id,
                       done_cb=lambda: self.actor.handle.call(
                           "tts_say_done", self.id)))
        fut.add_done_callback(
            lambda f, tok=token: self.actor.handle.call(
                "say_started", self.id, tok, f))

    def say_started(self, token, fut) -> None:
        if self.closed:
            return
        if token in self._stop_on_start:  # barge-in beat the resolution
            self._stop_on_start.discard(token)
            try:
                say_id = fut.result()
            except Exception:
                return
            self.actor.tts_actr.call("tts_session_stop_saying",
                                     self.tts_sess_id, say_id)
            return
        if self.saying is not token:
            return  # say already finished (done_cb won the race) or reset
        try:
            self.saying = fut.result()
        except Exception:
            log.exception("AIASession %s: tts say failed; skipping", self.id)
            self.saying = None
            self._pump_say()

    def tts_say_done(self) -> None:
        if self.closed:
            return
        log.debug("AIASession %s: say done", self.id)
        self.saying = None
        self._pump_say()

    # -- teardown -----------------------------------------------------------------
    def term(self, hangup: bool = False) -> None:
        if self.closed:
            return
        self.closed = True
        a = self.actor
        a.stt_actr.call("stt_session_end", self.stt_sess_id)
        a.tts_actr.call("tts_session_end", self.tts_sess_id)
        a.llm_actr.call("llm_session_end", self.llm_sess_id)
        if hangup:
            a.sip_actr.call("sess_term", self.sip_sess_id)
        log.info("AIASession %s ended", self.id)
