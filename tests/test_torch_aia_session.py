"""The ten tests of ``tests/test_aia_session.py`` on the port's
``AIASession`` (``infernos_tpu_torch/apps/ai_attendant/session.py``), with
stub actors and no models: utterance aggregation and flush, barge-in, the
unaudible protocol, <nothingtosay>, stale LLM results, say-queue
serialization, translation when the languages differ.
"""

import types
import uuid

import numpy as np

from infernos_tpu_torch.apps.ai_attendant.session import (
    AIASession,
    INTERRUPTED,
    NOTHING_TO_SAY,
)
from infernos_tpu_torch.audio.chunk import AudioChunk
from infernos_tpu_torch.config.config import AIAProfileConf
from infernos_tpu_torch.serving.sessions import STTSentinel


class StubHandle:
    """Actor handle that executes calls synchronously and records them."""

    def __init__(self, target=None):
        self.calls = []
        self.target = target

    def call(self, method, *a, **kw):
        self.calls.append((method, a, kw))
        if self.target is not None:
            getattr(self.target, method)(*a, **kw)

    def ask_sync(self, method, *a, timeout=None, **kw):
        self.calls.append((method, a, kw))
        if self.target is not None:
            return getattr(self.target, method)(*a, **kw)
        return None

    def ask(self, method, *a, **kw):
        from concurrent.futures import Future

        self.calls.append((method, a, kw))
        fut = Future()
        if self.target is not None:
            try:
                fut.set_result(getattr(self.target, method)(*a, **kw))
            except Exception as e:  # noqa: BLE001 - mirror actor mailbox
                fut.set_exception(e)
        else:
            fut.set_result(None)
        return fut


class StubModelActor:
    def __init__(self):
        self.log = []
        self.next_say_id = 0

    # TTS
    def new_tts_session(self):
        return uuid.uuid4()

    def tts_session_start(self, sid, soundout):
        self.log.append(("tts_start", sid))

    def tts_session_say(self, sid, req):
        self.log.append(("say", req.text))
        self.next_say_id += 1
        return self.next_say_id

    def tts_session_stop_saying(self, sid, say_id):
        self.log.append(("stop_saying", say_id))
        return True

    def tts_session_end(self, sid):
        self.log.append(("tts_end",))

    def get_rand_voice_id(self):
        return 7

    # STT
    def new_stt_session(self, keep_context=False):
        return uuid.uuid4()

    def stt_session_soundin(self, sid, req):
        self.log.append(("soundin", type(req).__name__))
        if isinstance(req, STTSentinel):
            req.text_cb(req)

    def stt_session_end(self, sid):
        self.log.append(("stt_end",))

    # LLM
    def new_llm_session(self, prompt=""):
        return uuid.uuid4()

    def llm_session_textin(self, sid, text, cb, auto_ctx_add=True,
                           req_id=None):
        self.log.append(("llm_in", text))
        self.last_cb = cb
        return len([e for e in self.log if e[0] == "llm_in"]) - 1

    def llm_session_context_add(self, sid, content, role="user"):
        self.log.append(("ctx_add", content))

    def llm_session_end(self, sid):
        self.log.append(("llm_end",))


class StubOffer:
    def __init__(self):
        self.sess_info = types.SimpleNamespace(
            call_id="c1", from_name="Test", from_number="100")

    def accept(self, disc_cb=None):
        return types.SimpleNamespace(sip_sess_id=uuid.uuid4(),
                                     rtp_sess_id=uuid.uuid4())


class StubActor:
    """Stands in for AIAActor: same attribute surface."""

    def __init__(self):
        self.profile = AIAProfileConf(name="t", llm_prompt="be brief")
        self.model = StubModelActor()
        self.tts_actr = StubHandle(self.model)
        self.stt_actr = StubHandle(self.model)
        self.llm_actr = StubHandle(self.model)
        self.rtp_actr = StubHandle()
        self.sip_actr = StubHandle()
        self.handle = StubHandle(self)  # route handle.call -> methods below
        self.translate = lambda text: text  # langs match: identity
        self.sess = None

    # routed callbacks (normally AIAActor methods)
    def text_in(self, sid, res):
        self.sess.text_in(res)

    def stt_flush(self, sid):
        self.sess.stt_flush()

    def text_out(self, sid, r):
        self.sess.text_out(r)

    def tts_say_done(self, sid):
        self.sess.tts_say_done()

    def say_started(self, sid, token, fut):
        self.sess.say_started(token, fut)

    def audio_in(self, sid, chunk):
        self.sess.audio_in(chunk)

    def sess_term(self, sid):
        self.sess.term()


def _mk():
    actor = StubActor()
    sess = AIASession(actor, StubOffer())
    actor.sess = sess
    return actor, sess


def _res(text, ns=0.0, dur=1.0):
    return types.SimpleNamespace(text=text, no_speech_prob=ns, duration=dur)


def _llm(text, final, req_id):
    return types.SimpleNamespace(text=text, is_final=final, req_id=req_id)


def test_metadata_injected():
    actor, sess = _mk()
    assert any(e[0] == "ctx_add" and "incoming call" in e[1]
               for e in actor.model.log)


def test_flush_sends_joined_utterance_to_llm():
    actor, sess = _mk()
    sess.text_in(_res("hello there"))
    sess.text_in(_res("how are you"))
    sess.stt_flush()
    llm_ins = [e for e in actor.model.log if e[0] == "llm_in"]
    assert llm_ins == [("llm_in", "hello there how are you")]
    assert sess.live_req_id == 0


def test_unaudible_protocol():
    actor, sess = _mk()
    sess.text_in(_res("", ns=0.9, dur=1.0))  # short garbage: dropped
    assert sess.text_buffer == []
    sess.text_in(_res("", ns=0.9, dur=7.5))  # long: reported
    assert sess.text_buffer and "unaudible" in sess.text_buffer[0]


def test_llm_reply_spoken_and_serialized():
    actor, sess = _mk()
    sess.text_in(_res("question"))
    sess.stt_flush()
    sess.text_out(_llm("First answer sentence. Second one follows here.",
                       False, 0))
    says = [e for e in actor.model.log if e[0] == "say"]
    assert len(says) == 1  # one at a time; rest queued
    assert sess.say_queue or sess.saying
    sess.tts_say_done()
    says = [e for e in actor.model.log if e[0] == "say"]
    assert len(says) >= 1


def test_nothing_to_say_ignored():
    actor, sess = _mk()
    sess.text_in(_res("q"))
    sess.stt_flush()
    sess.text_out(_llm(NOTHING_TO_SAY, True, 0))
    assert not sess.say_queue and sess.saying is None


def test_stale_llm_result_dropped():
    actor, sess = _mk()
    sess.text_in(_res("one"))
    sess.stt_flush()
    sess.text_in(_res("two"))
    sess.stt_flush()  # live_req_id -> 1
    sess.text_out(_llm("old reply text here.", False, 0))  # stale id 0
    assert not sess.say_queue and sess.saying is None


def test_barge_in_stops_tts_and_informs_llm():
    actor, sess = _mk()
    sess.text_in(_res("q"))
    sess.stt_flush()
    sess.text_out(_llm("A very long first sentence to say. And a second one.",
                       False, 0))
    assert sess.saying is not None
    # caller speaks while we're talking
    sess.audio_in(AudioChunk(np.zeros(160, np.float32), 8000, active=True))
    assert sess.saying is None and not sess.say_queue
    assert any(e == ("stop_saying", 1) for e in actor.model.log)
    assert any(e[0] == "ctx_add" and e[1] == INTERRUPTED
               for e in actor.model.log)


def test_silence_triggers_flush_sentinel():
    import time as time_mod

    actor, sess = _mk()
    sess.text_in(_res("buffered"))
    sess.flush_armed = True
    sess.last_active = time_mod.monotonic() - 3.0  # >2 s of silence
    sess.audio_in(AudioChunk(np.zeros(160, np.float32), 8000, active=False))
    # sentinel went through the (synchronous stub) STT path -> flush -> LLM
    assert any(e[0] == "llm_in" for e in actor.model.log)


def test_term_cleans_up():
    actor, sess = _mk()
    sess.term()
    kinds = [e[0] for e in actor.model.log]
    assert "stt_end" in kinds and "tts_end" in kinds and "llm_end" in kinds
    # idempotent
    sess.term()


def test_cross_lang_reply_translated():
    """Reference translator-if-lang-differs (AIAActor.py:47-51): LLM output
    is translated to the TTS language before speaking."""
    actor, sess = _mk()
    from infernos_tpu_torch.t2t.translator import get_translator

    actor.profile = AIAProfileConf(name="t", stt_lang="en", tts_lang="pt",
                                   llm_prompt="be brief")
    actor.translate = get_translator("en", "pt").translate  # EchoBackend tags
    sess.text_in(_res("q"))
    sess.stt_flush()  # live_req_id -> 0
    sess.text_out(_llm("Hello there.", True, 0))
    said = [e[1] for e in actor.model.log if e[0] == "say"]
    assert said and said[0].startswith("[en->pt]"), said
