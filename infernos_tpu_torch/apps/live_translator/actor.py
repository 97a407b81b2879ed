"""LiveTranslator app actor.

Capability parity with ``Apps/LiveTranslator/LTActor.py``: per-language TTS
actors plus one shared STT actor (``:35-51``), translator chain per
direction with the numbers-to-words filter (``:20-22``), session routing,
and a ``precache`` warm-load mode that spins models up then stops
(``:53-65``).  ``device`` places the model actors it spawns: the card
unless the caller asks for the CPU.
"""

from __future__ import annotations

import uuid as uuid_mod
from typing import Dict, List, Optional

from ...cluster.actors import Actor, ActorHandle, spawn
from ...cluster.model_actors import STTActor, TTSActor
from ...t2t.translator import EchoBackend, Translator, get_translator
from ...utils.logging import get_logger
from ...utils.platform import model_start_timeout
from ...utils.metrics import metrics
from .session import LTSession

log = get_logger("apps.lt")


class LTActor(Actor):
    def __init__(self, profile, tiny: bool = True, translator_backend=None,
                 device=None):
        self.profile = profile
        self.tiny = tiny
        self.device = device
        if translator_backend is None:
            import os as _os

            if _os.environ.get("INFERNOS_MODEL_MODE") == "tiny-real":
                # trained tiny-real pipeline: exact lexicon translation
                # over the speechlang vocabulary (t2t/lexicon.py) -- real
                # language change between the legs, checkable ground truth
                from ...t2t.lexicon import LexiconBackend

                translator_backend = LexiconBackend()
        self.translator_backend = translator_backend or EchoBackend()
        self.sessions: Dict[uuid_mod.UUID, LTSession] = {}
        self.thumbstones: List[uuid_mod.UUID] = []
        self.handle: Optional[ActorHandle] = None
        self.sip_actr: Optional[ActorHandle] = None
        self.rtp_actr: Optional[ActorHandle] = None
        self.tts_actrs: Dict[str, ActorHandle] = {}
        self.stt_actr: Optional[ActorHandle] = None

    def start(self, handle: ActorHandle, sip_actr: ActorHandle,
              rtp_actr: ActorHandle,
              tts_actrs: Optional[Dict[str, ActorHandle]] = None,
              stt_actr: Optional[ActorHandle] = None) -> None:
        self.handle = handle
        self.sip_actr = sip_actr
        self.rtp_actr = rtp_actr
        if tts_actrs is not None:
            self.tts_actrs = tts_actrs
        else:
            for lang in self.profile.tts_langs:
                h = spawn(TTSActor, tiny=self.tiny, device=self.device,
                          name=f"tts:{self.profile.name}:{lang}")
                h.ask_sync("start", lang, timeout=model_start_timeout())
                self.tts_actrs[lang] = h
        if stt_actr is not None:
            self.stt_actr = stt_actr
        else:
            self.stt_actr = spawn(STTActor, tiny=self.tiny,
                                  device=self.device, name=f"stt:{self.profile.name}")
            self.stt_actr.ask_sync("start", timeout=model_start_timeout())
        log.info("LTActor %s ready (langs %s)", self.profile.name,
                 self.profile.tts_langs)

    def precache(self, handle: ActorHandle) -> None:
        """Warm-load models then release them (reference ``:53-65``)."""
        self.start(handle, sip_actr=None, rtp_actr=None)
        for h in self.tts_actrs.values():
            h.stop()
        if self.stt_actr:
            self.stt_actr.stop()
        self.tts_actrs = {}
        self.stt_actr = None

    def get_translator(self, from_code: str, to_code: str) -> Translator:
        return get_translator(from_code, to_code, backend=self.translator_backend)

    # -- session routing --------------------------------------------------------
    def new_sip_session_received(self, offer) -> None:
        try:
            sess = LTSession(self, offer)
        except Exception:
            log.exception("failed to bridge inbound call")
            return
        self.sessions[sess.id] = sess

    def _sess(self, sess_id) -> Optional[LTSession]:
        sess = self.sessions.get(sess_id)
        if sess is None:
            assert sess_id in self.thumbstones, sess_id
        return sess

    def vad_chunk_in(self, sess_id, dname, chunk) -> None:
        sess = self._sess(sess_id)
        if sess:
            sess.vad_chunk_in(dname, chunk)

    def text_in(self, sess_id, dname, res) -> None:
        metrics.observe("stt.inf_time", getattr(res, "inf_time", 0.0))
        sess = self._sess(sess_id)
        if sess:
            sess.text_in(dname, res)

    def tts_say_done(self, sess_id, dname) -> None:
        sess = self._sess(sess_id)
        if sess:
            sess.tts_say_done(dname)

    def say_started(self, sess_id, dname, token, fut) -> None:
        sess = self._sess(sess_id)
        if sess:
            sess.say_started(dname, token, fut)

    def sess_term(self, sess_id) -> None:
        sess = self.sessions.pop(sess_id, None)
        if sess is None:
            return
        self.thumbstones.append(sess_id)
        sess.term()
