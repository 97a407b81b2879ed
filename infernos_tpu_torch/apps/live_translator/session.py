"""LiveTranslator call session: a two-leg translated bridge.

Capability parity with ``Apps/LiveTranslator/LTSession.py``:

- inbound leg (Alice) accepted, outbound leg (Bob) dialed through the
  profile's ``outbound`` connector; the legs are coupled for teardown
  (``:170-190``);
- per direction: VAD speech segments -> STT in *translate* mode -> text
  translation chain -> TTS in the other party's language -> the other leg's
  output on mixer track 1 (``STTProxy``/``TTSProxy``, ``:52-90``);
- ``text_in`` drops results with ``no_speech_prob > 0.5``, translates,
  sentence-splits and re-merges to <=128-char groups (``:204-228``);
- each direction's say-queue is serialized by ``tts_say_done`` (``:230-236``).
"""

from __future__ import annotations

import os
import time
import uuid as uuid_mod
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ...audio.chunk import AudioChunk, VadAudioChunk
from ...audio.signals import vad_signals
from ...media.ingest import AudioInput
from ...serving.sessions import STTRequest, TTSRequest
from ...sip.agent import NewSessionRequest
from ...t2t import NumbersToWords, regroup_sentences, sent_split
from ...utils.logging import get_logger

log = get_logger("apps.lt.session")


@dataclass
class _Direction:
    """One translation direction (e.g. Alice(en) -> Bob(pt))."""

    name: str
    stt_lang: str
    tts_lang: str
    stt_sess_id: uuid_mod.UUID = None
    tts_sess_id: uuid_mod.UUID = None
    tts_actr: object = None
    translator: object = None
    n2w: object = None
    say_queue: List[str] = field(default_factory=list)
    saying: Optional[uuid_mod.UUID] = None
    speaker_id: Optional[int] = None


class LTSession:
    """One bridged, translated call."""

    def __init__(self, actor, offer) -> None:
        self.id = uuid_mod.uuid4()
        self.actor = actor
        self.closed = False
        prof = actor.profile
        lang_a, lang_b = prof.stt_langs[0], prof.stt_langs[1]

        # -- leg A (inbound; deferred accept then outbound dial, :170-180) ----
        res_a = offer.accept(disc_cb=lambda: actor.handle.call("sess_term", self.id))
        self.sip_a, self.rtp_a = res_a.sip_sess_id, res_a.rtp_sess_id

        # -- leg B (outbound) ---------------------------------------------------
        conn, cld = prof.outbound_parts()
        try:
            res_b = actor.sip_actr.ask_sync(
                "new_session",
                NewSessionRequest(conn=conn, cld=cld,
                                  disc_cb=lambda: actor.handle.call(
                                      "sess_term", self.id)),
                timeout=40.0)
        except Exception:
            actor.sip_actr.call("sess_term", self.sip_a)
            raise
        self.sip_b, self.rtp_b = res_b.sip_sess_id, res_b.rtp_sess_id

        # -- directions ---------------------------------------------------------
        self.dirs: Dict[str, _Direction] = {}
        for name, s_lang, t_lang, src_rtp, dst_rtp in (
                ("a2b", lang_a, lang_b, self.rtp_a, self.rtp_b),
                ("b2a", lang_b, lang_a, self.rtp_b, self.rtp_a)):
            d = _Direction(name, s_lang, t_lang)
            d.tts_actr = actor.tts_actrs[t_lang]
            d.stt_sess_id = actor.stt_actr.ask_sync("new_stt_session", True)
            d.tts_sess_id = d.tts_actr.ask_sync("new_tts_session")
            d.speaker_id = d.tts_actr.ask_sync("get_rand_voice_id")
            # TTS audio goes to the DESTINATION leg on mixer track 1
            # (reference TTSProxy track_id=1, :78-90)

            def mk_soundout(dst=dst_rtp):
                def soundout(chunk):
                    chunk.track_id = 1
                    actor.rtp_actr.call("rtp_session_soundout", dst, chunk)
                return soundout

            d.tts_actr.ask_sync("tts_session_start", d.tts_sess_id, mk_soundout())
            d.translator = actor.get_translator(s_lang, t_lang)
            d.n2w = NumbersToWords(t_lang)
            self.dirs[name] = d
            # audible VAD signals: mirror an engage/disengage jingle back to
            # the SPEAKER's leg on its own mixer track when speech capture
            # starts/stops (reference VADSignals, LTSession.py:44-50; tones
            # synthesized locally instead of URL-fetched).  Transition
            # detection runs inline on the VAD worker thread so the actor
            # mailbox sees only transitions, not every 20 ms window.
            eng_tone, deng_tone = vad_signals(8000)

            def mk_audio_in(src=src_rtp, state={"active": False}):
                def audio_in(chunk):
                    act = bool(getattr(chunk, "active", False))
                    if act == state["active"]:
                        return
                    state["active"] = act
                    tone = AudioChunk((eng_tone if act else deng_tone).copy(),
                                      8000)
                    tone.track_id = 2
                    actor.rtp_actr.call("rtp_session_soundout", src, tone)
                return audio_in

            actor.rtp_actr.call(
                "rtp_session_connect", src_rtp,
                AudioInput(
                    audio_in=mk_audio_in(),
                    vad_chunk_in=lambda chunk, dn=name: actor.handle.call(
                        "vad_chunk_in", self.id, dn, chunk)))
        log.info("LTSession %s bridged %s<->%s", self.id, lang_a, lang_b)

    # -- per-direction flow ------------------------------------------------------
    def vad_chunk_in(self, dname: str, chunk: VadAudioChunk) -> None:
        if self.closed:
            return
        d = self.dirs[dname]
        log.debug("LTSession %s %s: vad chunk %d samples", self.id, dname,
                  len(chunk.audio))
        dump_dir = os.environ.get("INFERNOS_DUMP_VAD")
        if dump_dir:  # debugging aid: save captured segments as .npy
            import numpy as _np
            _np.save(os.path.join(
                dump_dir, f"vad_{dname}_{int(time.monotonic()*1000)}.npy"),
                _np.asarray(chunk.audio))
        self.actor.stt_actr.call(
            "stt_session_soundin", d.stt_sess_id,
            STTRequest(chunk=chunk, lang=d.stt_lang, mode="translate",
                       text_cb=lambda res, dn=dname: self.actor.handle.call(
                           "text_in", self.id, dn, res)))

    def text_in(self, dname: str, res) -> None:
        if self.closed:
            return
        log.debug("LTSession %s %s: stt %r (ns_prob %.2f)", self.id, dname,
                  res.text, res.no_speech_prob)
        if res.no_speech_prob > 0.5:  # reference gate, :204-206
            return
        text = res.text.strip()
        if not text:
            return
        d = self.dirs[dname]
        translated = d.translator.translate(text)
        log.debug("LTSession %s %s: translated %r", self.id, dname, translated)
        for group in regroup_sentences(sent_split(d.n2w(translated))):
            d.say_queue.append(group)
        self._pump_say(d)

    def _pump_say(self, d: _Direction) -> None:
        """Start the next queued utterance WITHOUT blocking the actor
        mailbox: a synchronous ask here serializes every session's say
        behind one TTS-actor round-trip, and one slow ask (busy engine)
        cascades into 30 s-per-message app wedges (round-4 ramp).  The ask
        resolves via a ``say_started`` hop back onto this actor's mailbox."""
        if d.saying is not None or not d.say_queue:
            return
        text = d.say_queue.pop(0)
        log.debug("LTSession %s %s: say %r", self.id, d.name, text)
        token = object()  # placeholder until the say_id resolves
        d.saying = token
        fut = d.tts_actr.ask(
            "tts_session_say", d.tts_sess_id,
            TTSRequest(text, speaker_id=d.speaker_id,
                       done_cb=lambda dn=d.name: self.actor.handle.call(
                           "tts_say_done", self.id, dn)))
        fut.add_done_callback(
            lambda f, dn=d.name, tok=token: self.actor.handle.call(
                "say_started", self.id, dn, tok, f))

    def say_started(self, dname: str, token, fut) -> None:
        if self.closed:
            return
        d = self.dirs[dname]
        if d.saying is not token:
            return  # say already finished (done_cb won the race) or reset
        try:
            d.saying = fut.result()
        except Exception:
            log.exception("LTSession %s: tts say failed; skipping utterance",
                          self.id)
            d.saying = None
            self._pump_say(d)

    def tts_say_done(self, dname: str) -> None:
        if self.closed:
            return
        log.debug("LTSession %s %s: say done", self.id, dname)
        d = self.dirs[dname]
        d.saying = None
        self._pump_say(d)

    # -- teardown -----------------------------------------------------------------
    def term(self, hangup: bool = True) -> None:
        if self.closed:
            return
        self.closed = True
        a = self.actor
        for d in self.dirs.values():
            a.stt_actr.call("stt_session_end", d.stt_sess_id)
            d.tts_actr.call("tts_session_end", d.tts_sess_id)
        if hangup:
            a.sip_actr.call("sess_term", self.sip_a)
            a.sip_actr.call("sess_term", self.sip_b)
        log.info("LTSession %s ended", self.id)
