"""Port's session layer, driver, batcher and small utilities vs the
originals (``infernos_tpu/serving/sessions.py`` and friends), on the CPU.

``TTSSoundDispatch``: the same chunks through both give the same output
(gain lock at rms > 1e-7, leading silence unscaled, clip at 0.95).
``STTSession``: serialised requests, VAD-chunk merging, sentinel flush.
``TTSSession``: say chains, ``stop_saying``, ``end``.  Every thread a test
starts is joined with a timeout.
"""

import threading
import time

import numpy as np
import pytest
import torch

from infernos_tpu.audio.chunk import AudioChunk as JAudioChunk
from infernos_tpu.serving import sessions as jses
from infernos_tpu.utils.metrics import Metrics as JMetrics
from infernos_tpu_torch.audio.chunk import AudioChunk, VadAudioChunk
from infernos_tpu_torch.audio.markers import ASMarkerNewSent, ASMarkerSentDoneCB
from infernos_tpu_torch.serving import sessions as ses
from infernos_tpu_torch.serving.batcher import BatchedWorker
from infernos_tpu_torch.serving.driver import EngineDriver
from infernos_tpu_torch.serving.stt_engine import STTEngineConfig, STTResult
from infernos_tpu_torch.utils.logging import get_logger, stdtss
from infernos_tpu_torch.utils.metrics import Metrics, metrics
from infernos_tpu_torch.utils.threads import WrkState, WrkThread


def _chunks(case):
    rng = np.random.default_rng(len(case))
    n = 512
    speech = (0.01 * rng.standard_normal(n)).astype(np.float32)
    return {
        "speech-first": [speech, 2 * speech, 0.5 * speech],
        "leading-silence": [np.zeros(n, np.float32), 1e-9 * speech, speech, 3 * speech],
        "just-under-threshold": [np.full(n, 0.9e-7, np.float32), speech],
        "just-over-threshold": [np.full(n, 1.1e-7, np.float32), speech],
        "clips": [speech, 400 * speech],
        "empty-first": [np.zeros(0, np.float32), speech],
    }[case]


CASES = ["speech-first", "leading-silence", "just-under-threshold",
         "just-over-threshold", "clips", "empty-first"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("norm", [0.05, 0.0])
def test_sound_dispatch_gain_lock_matches_reference(case, norm):
    got, want, done = [], [], []
    mine = ses.TTSSoundDispatch(got.append, 16000, lambda: done.append("m"), norm_rms=norm)
    ref = jses.TTSSoundDispatch(want.append, 16000, lambda: done.append("r"), norm_rms=norm)
    for c in _chunks(case):
        mine(c.copy())
        ref(c.copy())
    mine(None)
    ref(None)
    assert len(got) == len(want) == len(_chunks(case)) + 1
    for g, w in zip(got[:-1], want[:-1]):
        assert isinstance(g, AudioChunk) and isinstance(w, JAudioChunk)
        assert g.samplerate == w.samplerate == 16000
        np.testing.assert_array_equal(g.audio, w.audio)
    assert mine._gain == ref._gain
    if norm and case == "leading-silence":  # silence passed through unscaled
        np.testing.assert_array_equal(got[0].audio, _chunks(case)[0])
        np.testing.assert_array_equal(got[1].audio, _chunks(case)[1])
        assert abs(float(np.sqrt(np.mean(got[2].audio ** 2))) - norm) < 1e-3
    if norm and case == "just-under-threshold":
        assert np.abs(got[0].audio).max() < 1e-6  # no lock on it
    if norm and case == "clips":
        assert np.abs(got[1].audio).max() == np.float32(0.95)
    assert isinstance(got[-1], ASMarkerSentDoneCB) and got[-1].sync
    got[-1].on_proc()
    assert done == ["m"]


def test_sound_dispatch_cancel_emits_end_once_and_drops_audio():
    out, cleaned = [], []
    d = ses.TTSSoundDispatch(out.append, 16000, None)
    d.cleanup_cb = lambda: cleaned.append(1)
    d(np.ones(4, np.float32))
    d.cancel()
    d(np.ones(4, np.float32))
    d(None)
    assert len(out) == 2 and type(out[1]) is ASMarkerNewSent and cleaned == [1]


class _FakeSTT:
    """Engine stand-in: keeps submitted requests; ``finish`` answers one."""

    def __init__(self):
        self.ecfg = STTEngineConfig(context_tokens=4)
        self.reqs = []

    def submit(self, req):
        self.reqs.append(req)

    def finish(self, tokens=(1, 2, 3)):
        req = self.reqs.pop(0)
        req.text_cb(STTResult(tokens=list(tokens), no_speech_prob=0.0,
                              duration=len(req.audio) / 16000, inf_time=0.0,
                              text=" ".join(map(str, tokens))))


def _vad(ipos, n=800):
    return VadAudioChunk(np.full(n, 0.1, np.float32), 8000, ipos=ipos)


def test_stt_session_serialises_merges_and_flushes():
    eng, got = _FakeSTT(), []
    s = ses.STTSession(eng, keep_context=True)
    s.soundin(ses.STTRequest(_vad(0), got.append))
    s.soundin(ses.STTRequest(_vad(1600), got.append))   # queued behind the first
    s.soundin(ses.STTRequest(_vad(4000), got.append))   # merges into the second
    s.soundin(ses.STTSentinel("flush", got.append))
    assert len(eng.reqs) == 1 and s.busy and got == []
    assert len(eng.reqs[0].audio) == 1600  # 800 samples @8k resampled to 16k
    assert eng.reqs[0].context is None
    eng.finish((1, 2, 3))
    assert len(got) == 1 and len(eng.reqs) == 1
    merged = eng.reqs[0]
    assert len(merged.audio) == 2 * (4000 + 800 - 1600)  # gap zero-filled
    np.testing.assert_array_equal(merged.context, [1, 2, 3])
    eng.finish((4, 5, 6))
    assert [type(g).__name__ for g in got] == ["STTResult", "STTResult", "STTSentinel"]
    assert s.context == [3, 4, 5, 6] and not s.busy  # bounded by context_tokens
    # a sentinel with nothing queued passes straight through
    s.soundin(ses.STTSentinel("flush", got.append))
    assert got[-1].signal == "flush" and len(got) == 4
    s.stop()
    s.soundin(ses.STTRequest(_vad(9000), got.append))
    assert eng.reqs == []


def test_stt_session_same_requests_as_reference():
    """The same chunk sequence through both session classes reaches the
    engine as the same audio, in the same number of requests."""
    from infernos_tpu.audio.chunk import VadAudioChunk as JVad

    mine, ref = _FakeSTT(), _FakeSTT()
    a, b = ses.STTSession(mine), jses.STTSession(ref)
    rng = np.random.default_rng(0)
    for ipos in (0, 2000, 5000, 9000):
        audio = rng.standard_normal(900).astype(np.float32)
        a.soundin(ses.STTRequest(VadAudioChunk(audio.copy(), 8000, ipos=ipos), lambda r: None))
        b.soundin(jses.STTRequest(JVad(audio.copy(), 8000, ipos=ipos), lambda r: None))
    n = 0
    while mine.reqs:
        assert len(mine.reqs) == len(ref.reqs) == 1
        np.testing.assert_allclose(mine.reqs[0].audio, ref.reqs[0].audio, atol=1e-6)
        mine.finish()
        ref.finish()
        n += 1
    assert n == 2 and not ref.reqs


class _FakeTTS:
    def __init__(self):
        from infernos_tpu_torch.serving.tts_engine import TTSEngineConfig

        self.ecfg = TTSEngineConfig(output_norm_rms=0.05)
        self.cfg = type("C", (), {"speaker_embedding_dim": 8})()
        self.started, self.cancelled = [], []

    def start_session(self, ids, spk, cb):
        self.started.append((ids, spk, cb))
        return len(self.started) - 1

    def cancel_session(self, sid):
        self.cancelled.append(sid)


def test_tts_session_say_chain_stop_and_end():
    eng, out, done = _FakeTTS(), [], []
    s = ses.TTSSession(eng, lambda t: np.array([ord(c) for c in t]))
    with pytest.raises(AssertionError):
        s.say(ses.TTSRequest("x"))
    s.start(out.append)
    s.say(ses.TTSRequest(["ab", "cd"], done_cb=lambda: done.append(1)))
    assert len(eng.started) == 1 and list(eng.started[0][0]) == [97, 98]
    assert eng.started[0][1].shape == (8,) and eng.started[0][2].norm_rms == 0.05
    cb = eng.started[0][2]
    cb(np.full(16, 0.01, np.float32))
    cb(None)
    assert isinstance(out[0], AudioChunk) and isinstance(out[1], ASMarkerSentDoneCB)
    out[1].on_proc()  # the first sentence is done playing: the second starts
    assert len(eng.started) == 2 and list(eng.started[1][0]) == [99, 100] and done == []
    eng.started[1][2](None)
    out[2].on_proc()
    assert done == [1] and s.active == {}
    say_id = s.say(ses.TTSRequest("zz"))
    assert s.stop_saying(say_id) and eng.cancelled == [2]
    assert type(out[-1]) is ASMarkerNewSent and not s.stop_saying(say_id)
    s.say(ses.TTSRequest("yy"))
    s.end()
    assert eng.cancelled == [2, 3] and s.active == {}


def test_tts_session_uses_the_speaker_bank():
    from infernos_tpu_torch.serving.speakers import SpeakerBank

    eng = _FakeTTS()
    bank = SpeakerBank.synthetic(dim=8, n=5)
    s = ses.TTSSession(eng, lambda t: np.zeros(1), bank)
    s.start(lambda item: None)
    s.say(ses.TTSRequest("a", speaker_id=3))
    np.testing.assert_array_equal(eng.started[0][1], bank.get(3))
    req = ses.TTSRequest("b")
    s.say(req)
    assert req.speaker_id is not None and 0 <= req.speaker_id < 5


def test_llm_session_context_merge():
    s = ses.LLMSession(engine=None, tokenize=lambda t: np.zeros(1), system_prompt="sys")
    s.context_add("a")
    s.context_add("b")
    s.context_add("c", role="assistant")
    assert s.context == [{"role": "system", "content": "sys"},
                         {"role": "user", "content": "a\nb"},
                         {"role": "assistant", "content": "c"}]
    assert ses.LLMResult("t", True, 1).is_final


class _CountingEngine:
    def __init__(self, fail_at=()):
        self.steps, self.work, self.aborts = 0, 0, []
        self.fail_at = set(fail_at)
        self.idle = threading.Event()

    def step(self):
        self.steps += 1
        if self.steps in self.fail_at:
            raise RuntimeError("boom")
        if self.work > 0:
            self.work -= 1
            return True
        self.idle.set()
        return False

    def abort_all(self, reason):
        self.aborts.append(reason)


def test_engine_driver_runs_parks_and_survives_a_crash():
    eng = _CountingEngine(fail_at={2})
    before = metrics.counters.get("driver.crashes", 0)
    drv = EngineDriver(eng, name="t", max_crashes=3)
    eng.work = 5
    drv.start()
    drv.kick()
    assert eng.idle.wait(timeout=10)
    drv.stop(join=False)
    drv.join(timeout=10)
    assert not drv.is_alive()
    assert eng.work == 0 and len(eng.aborts) == 1 and "RuntimeError" in eng.aborts[0]
    assert metrics.counters.get("driver.crashes", 0) == before + 1


def test_engine_driver_stops_on_a_crash_storm():
    eng = _CountingEngine(fail_at={1, 2, 3})
    drv = EngineDriver(eng, name="storm", max_crashes=3, crash_window_s=30.0)
    drv.start()
    for _ in range(3):
        drv.kick()
    drv.join(timeout=10)
    assert not drv.is_alive() and len(eng.aborts) == 3
    drv.stop()


def test_batched_worker_batches_and_stops():
    seen, got_all = [], threading.Event()

    class W(BatchedWorker):
        max_batch_size = 4
        batch_wait_s = 0.05

        def process_batch(self, batch):
            seen.append(list(batch))
            if sum(map(len, seen)) == 10:
                got_all.set()

    w = W(name="bw")
    for i in range(10):
        w.infer(i)
    w.start()
    assert got_all.wait(timeout=10)
    w.stop(join=False)
    w.join(timeout=10)
    assert not w.is_alive()
    assert [x for b in seen for x in b] == list(range(10))
    assert max(map(len, seen)) == 4


def test_wrk_thread_lifecycle():
    ran = threading.Event()

    class T(WrkThread):
        def run(self):
            ran.set()
            while self.should_run():
                time.sleep(0.005)

    t = T(name="wt")
    assert t._state == WrkState.INIT
    t.start()
    assert ran.wait(timeout=10)
    t.stop(join=False)
    t.join(timeout=10)
    assert not t.is_alive()


def test_metrics_match_reference():
    a, b = Metrics(), JMetrics()
    for m in (a, b):
        m.inc("c")
        m.inc("c", 2)
        m.set("g", 7)
        for v in (0.1, 0.5, 0.2, 0.9):
            m.observe("h", v)
    assert a.counters["c"] == b.counters["c"] == 3
    assert a.snapshot() == b.snapshot()
    assert get_logger("serving.x").name == "infernos_tpu_torch.serving.x"
    assert float(stdtss()) > 0
