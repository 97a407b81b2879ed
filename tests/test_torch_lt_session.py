"""LTSession state-machine tests with stub actors (no models, no SIP).

The port's copy of ``tests/test_lt_session.py``, run against ``infernos_tpu_torch``.
"""

import types
import uuid

import numpy as np
import pytest

from infernos_tpu_torch.apps.live_translator.session import LTSession
from infernos_tpu_torch.audio.chunk import VadAudioChunk
from infernos_tpu_torch.config.config import LTProfileConf
from infernos_tpu_torch.t2t.translator import EchoBackend, get_translator


class StubHandle:
    def __init__(self, target=None):
        self.calls = []
        self.target = target

    def call(self, method, *a, **kw):
        self.calls.append((method, a))
        if self.target is not None:
            getattr(self.target, method)(*a, **kw)

    def ask_sync(self, method, *a, timeout=None, **kw):
        self.calls.append((method, a))
        if self.target is not None:
            return getattr(self.target, method)(*a, **kw)
        return None

    def ask(self, method, *a, **kw):
        from concurrent.futures import Future

        self.calls.append((method, a))
        fut = Future()
        if self.target is not None:
            try:
                fut.set_result(getattr(self.target, method)(*a, **kw))
            except Exception as e:  # noqa: BLE001 - mirror actor mailbox
                fut.set_exception(e)
        else:
            fut.set_result(None)
        return fut


class StubModel:
    def __init__(self):
        self.log = []
        self._say = 0

    def new_stt_session(self, keep_context=False):
        return uuid.uuid4()

    def stt_session_soundin(self, sid, req):
        self.log.append(("soundin", req.mode, req.lang))

    def stt_session_end(self, sid):
        self.log.append(("stt_end",))

    def new_tts_session(self):
        return uuid.uuid4()

    def tts_session_start(self, sid, soundout):
        self.log.append(("tts_start",))
        self.soundout = soundout

    def tts_session_say(self, sid, req):
        self.log.append(("say", req.text))
        self._say += 1
        return self._say

    def tts_session_end(self, sid):
        self.log.append(("tts_end",))

    def get_rand_voice_id(self):
        return 3


class StubSip:
    def __init__(self):
        self.log = []

    def new_session(self, req):
        self.log.append(("new_session", req.conn, req.cld))
        return types.SimpleNamespace(sip_sess_id=uuid.uuid4(),
                                     rtp_sess_id=uuid.uuid4())

    def sess_term(self, sid):
        self.log.append(("sess_term", sid))


class StubOffer:
    def __init__(self):
        self.sess_info = types.SimpleNamespace(call_id="c", from_name="A",
                                               from_number="1")

    def accept(self, disc_cb=None):
        return types.SimpleNamespace(sip_sess_id=uuid.uuid4(),
                                     rtp_sess_id=uuid.uuid4())


class StubActor:
    def __init__(self):
        self.profile = LTProfileConf(name="c1", stt_langs=["en", "pt"],
                                     tts_langs=["pt", "en"],
                                     outbound="sip/bob;cld=900")
        self.model = StubModel()
        self.stt_actr = StubHandle(self.model)
        self.tts_actrs = {"en": StubHandle(self.model),
                          "pt": StubHandle(self.model)}
        self.rtp_actr = StubHandle()
        self.sipstub = StubSip()
        self.sip_actr = StubHandle(self.sipstub)
        self.handle = StubHandle(self)
        self.sess = None

    def get_translator(self, a, b):
        return get_translator(a, b, backend=EchoBackend())

    def vad_chunk_in(self, sid, dn, chunk):
        self.sess.vad_chunk_in(dn, chunk)

    def text_in(self, sid, dn, res):
        self.sess.text_in(dn, res)

    def tts_say_done(self, sid, dn):
        self.sess.tts_say_done(dn)

    def say_started(self, sid, dn, token, fut):
        self.sess.say_started(dn, token, fut)

    def sess_term(self, sid):
        self.sess.term()


def _mk():
    actor = StubActor()
    sess = LTSession(actor, StubOffer())
    actor.sess = sess
    return actor, sess


def _res(text, ns=0.0):
    return types.SimpleNamespace(text=text, no_speech_prob=ns, duration=1.0,
                                 inf_time=0.1)


def test_bridge_dials_outbound():
    actor, sess = _mk()
    assert ("new_session", "sip/bob", "900") in actor.sipstub.log
    assert set(sess.dirs) == {"a2b", "b2a"}
    # directions speak the other party's language
    assert sess.dirs["a2b"].stt_lang == "en" and sess.dirs["a2b"].tts_lang == "pt"
    assert sess.dirs["b2a"].stt_lang == "pt" and sess.dirs["b2a"].tts_lang == "en"


def test_vad_chunk_goes_to_stt_translate_mode():
    actor, sess = _mk()
    chunk = VadAudioChunk(np.zeros(800, np.float32), 8000, ipos=0)
    sess.vad_chunk_in("a2b", chunk)
    assert ("soundin", "translate", "en") in actor.model.log


def test_text_in_translates_and_says():
    actor, sess = _mk()
    sess.text_in("a2b", _res("hello world, nice day."))
    says = [e for e in actor.model.log if e[0] == "say"]
    assert len(says) == 1
    assert "[en->pt]" in says[0][1]  # EchoBackend tags the direction


def test_ns_prob_gate():
    actor, sess = _mk()
    sess.text_in("a2b", _res("noise", ns=0.9))
    assert not [e for e in actor.model.log if e[0] == "say"]


def test_say_queue_serialized_per_direction():
    actor, sess = _mk()
    long_text = ("First sentence here today. " * 8).strip()  # > 128 chars
    sess.text_in("a2b", _res(long_text))
    says = [e for e in actor.model.log if e[0] == "say"]
    assert len(says) == 1  # one in flight
    assert sess.dirs["a2b"].say_queue  # rest queued
    sess.tts_say_done("a2b")
    says = [e for e in actor.model.log if e[0] == "say"]
    assert len(says) == 2


def test_term_hangs_up_both_legs():
    actor, sess = _mk()
    sess.term()
    terms = [e for e in actor.sipstub.log if e[0] == "sess_term"]
    assert len(terms) == 2
    assert ("stt_end",) in actor.model.log and ("tts_end",) in actor.model.log
    sess.term()  # idempotent
