"""AIAttendant app actor.

Capability parity with ``Apps/AIAttendant/AIAActor.py``: spawns/uses
TTS + STT + LLM actors (``:42-45``), routes ``new_sip_session_received`` /
``text_in`` / ``text_out`` / ``tts_say_done`` / ``sess_term`` to sessions,
and keeps a thumbstone list so late calls on ended sessions are idempotent
(``:62-71``).

Port of ``infernos_tpu/apps/ai_attendant/actor.py``; ``device`` places the
model actors it spawns: the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import uuid as uuid_mod
from typing import Dict, List, Optional

from ...cluster.actors import Actor, ActorHandle, spawn
from ...cluster.model_actors import LLMActor, STTActor, TTSActor
from ...utils.logging import get_logger
from ...utils.platform import model_start_timeout
from .session import AIASession

log = get_logger("apps.aia")


class AIAActor(Actor):
    def __init__(self, profile, tiny: bool = True, translator_backend=None,
                 device=None):
        self.profile = profile
        self.tiny = tiny
        self.device = device
        # LLM replies are translated when the attendant's STT language
        # differs from its TTS voice (reference translator-if-lang-differs,
        # Apps/AIAttendant/AIAActor.py:47-51); identity when langs match
        if profile.stt_lang != profile.tts_lang:
            from ...t2t.translator import get_translator

            self.translate = get_translator(
                profile.stt_lang, profile.tts_lang,
                backend=translator_backend).translate
        else:
            self.translate = lambda text: text
        self.sessions: Dict[uuid_mod.UUID, AIASession] = {}
        self.thumbstones: List[uuid_mod.UUID] = []
        # wired by start()
        self.handle: Optional[ActorHandle] = None
        self.sip_actr: Optional[ActorHandle] = None
        self.rtp_actr: Optional[ActorHandle] = None
        self.tts_actr: Optional[ActorHandle] = None
        self.stt_actr: Optional[ActorHandle] = None
        self.llm_actr: Optional[ActorHandle] = None

    def start(self, handle: ActorHandle, sip_actr: ActorHandle,
              rtp_actr: ActorHandle,
              tts_actr: Optional[ActorHandle] = None,
              stt_actr: Optional[ActorHandle] = None,
              llm_actr: Optional[ActorHandle] = None) -> None:
        self.handle = handle
        self.sip_actr = sip_actr
        self.rtp_actr = rtp_actr
        self.tts_actr = tts_actr or spawn(TTSActor, tiny=self.tiny,
                                          device=self.device,
                                          name=f"tts:{self.profile.name}")
        self.stt_actr = stt_actr or spawn(STTActor, tiny=self.tiny,
                                          device=self.device,
                                          name=f"stt:{self.profile.name}")
        self.llm_actr = llm_actr or spawn(LLMActor, tiny=self.tiny,
                                          device=self.device,
                                          name=f"llm:{self.profile.name}")
        if tts_actr is None:
            self.tts_actr.ask_sync("start", self.profile.tts_lang,
                                   timeout=model_start_timeout())
        if stt_actr is None:
            self.stt_actr.ask_sync("start", timeout=model_start_timeout())
        if llm_actr is None:
            self.llm_actr.ask_sync("start", timeout=model_start_timeout())
        log.info("AIAActor %s ready", self.profile.name)

    # -- session routing --------------------------------------------------------
    def new_sip_session_received(self, offer) -> None:
        sess = AIASession(self, offer)
        self.sessions[sess.id] = sess

    def _sess(self, sess_id) -> Optional[AIASession]:
        sess = self.sessions.get(sess_id)
        if sess is None:
            assert sess_id in self.thumbstones, sess_id
        return sess

    def audio_in(self, sess_id, chunk) -> None:
        sess = self._sess(sess_id)
        if sess:
            sess.audio_in(chunk)

    def vad_chunk_in(self, sess_id, chunk) -> None:
        sess = self._sess(sess_id)
        if sess:
            sess.vad_chunk_in(chunk)

    def text_in(self, sess_id, res) -> None:
        sess = self._sess(sess_id)
        if sess:
            sess.text_in(res)

    def stt_flush(self, sess_id) -> None:
        sess = self._sess(sess_id)
        if sess:
            sess.stt_flush()

    def text_out(self, sess_id, r) -> None:
        sess = self._sess(sess_id)
        if sess:
            sess.text_out(r)

    def tts_say_done(self, sess_id) -> None:
        sess = self._sess(sess_id)
        if sess:
            sess.tts_say_done()

    def say_started(self, sess_id, token, fut) -> None:
        sess = self._sess(sess_id)
        if sess:
            sess.say_started(token, fut)

    def sess_term(self, sess_id, hangup: bool = False) -> None:
        sess = self.sessions.pop(sess_id, None)
        if sess is None:
            return
        self.thumbstones.append(sess_id)
        sess.term(hangup=hangup)
