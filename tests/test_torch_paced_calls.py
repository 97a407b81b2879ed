"""The paced concurrent-call bench harness of ``tests/test_paced_calls.py``
on the port (``infernos_tpu_torch.bench.paced_calls``, the port's tiny TTS
engine on the CPU).

How these copies differ from the reference's tests: ``run_paced`` and
``_Call`` read the time through ``paced_calls.time``, and the copies that
drive the engine replace it with :class:`VirtualClock`.  Each engine step
that dispatches a tick advances it by ``TICK_S``, a step that dispatches
nothing by ``IDLE_S``, and a sleep by its argument.  The pacing model,
flow control, TTFB and underrun accounting are then measured on ticks, not
on how the host's scheduler treats the test's threads: on a loaded CPU a
single tick can stall for longer than the 60 ms grace, and the reference's
copy then counts an underrun against an SLA that only a real-time host can
hold.  Every bookkeeping assertion of the reference stays, and
:func:`test_paced_calls_count_underruns_on_a_slow_clock` shows that the
same accounting fails a run whose ticks are slower than the audio they
make.
"""

import threading

import numpy as np
import pytest
import torch

from infernos_tpu_torch.bench import paced_calls
from infernos_tpu_torch.bench.paced_calls import (
    PacedCallConfig, _Call, find_max_calls, run_paced,
)
from infernos_tpu_torch.models import hifigan as hfg
from infernos_tpu_torch.models import speecht5 as st5
from infernos_tpu_torch.serving.tts_engine import TTSEngine, TTSEngineConfig

TINY = st5.SpeechT5Config(
    vocab_size=64, hidden_size=64, encoder_layers=2,
    encoder_attention_heads=4, encoder_ffn_dim=128, decoder_layers=2,
    decoder_attention_heads=4, decoder_ffn_dim=128, num_mel_bins=20,
    speech_decoder_prenet_units=32, speech_decoder_prenet_layers=2,
    speech_decoder_postnet_units=32, speech_decoder_postnet_layers=2,
    reduction_factor=2, speaker_embedding_dim=16, max_text_positions=64,
    max_speech_positions=640, encoder_max_relative_position=16,
)
VOC = hfg.HifiGanConfig(
    model_in_dim=20, upsample_initial_channel=32, upsample_rates=(4, 4),
    upsample_kernel_sizes=(8, 8), resblock_kernel_sizes=(3,),
    resblock_dilation_sizes=((1, 3),),
)
# the virtual cost of one dispatched tick: 8 frames of this vocoder are
# 8 ms of audio, so a paced call hears the next chunk in time while a tick
# costs under 8 ms + the 60 ms grace
TICK_S = 0.01
IDLE_S = 0.001  # a step that dispatched nothing (and keeps the clock moving)


class VirtualClock:
    """Stands in for the ``time`` module that ``paced_calls`` reads."""

    def __init__(self):
        self.t = 1000.0
        self._lock = threading.Lock()

    def monotonic(self) -> float:
        return self.t

    def sleep(self, s: float) -> None:
        self.advance(max(s, 0.0))

    def advance(self, s: float) -> None:
        with self._lock:
            self.t += s


class Clocked:
    """An engine whose ``step`` advances ``clock`` by ``tick_s`` for each
    tick it dispatched (``IDLE_S`` when it dispatched none) before the
    tick's audio is handed out; everything else is the engine's."""

    def __init__(self, engine, clock, tick_s=TICK_S):
        self._engine, self._clock, self._tick_s = engine, clock, tick_s

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def step(self) -> bool:
        n = len(self._engine.tick_frames)
        more = self._engine.step()
        self._clock.advance(self._tick_s * (len(self._engine.tick_frames) - n) or IDLE_S)
        return more


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the tiny model's ops are small, and on a loaded
    CPU a thread pool waits on its slowest thread every op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engine(async_harvest):
    g = torch.Generator().manual_seed(0)
    eng = TTSEngine(
        st5.init_params(TINY, g, "cpu"), TINY, hfg.init_params(VOC, g, "cpu"), VOC,
        TTSEngineConfig(batch_slots=4, max_text_tokens=16, max_steps=64,
                        pre_frames=4, chunk_schedule=(8, 16), min_steps=2,
                        stop_threshold=2.0, async_harvest=async_harvest),
        device="cpu")
    eng.warmup()
    return eng


@pytest.fixture(scope="module")
def engine():
    return _engine(async_harvest=False)


@pytest.fixture
def clock(monkeypatch):
    c = VirtualClock()
    monkeypatch.setattr(paced_calls, "time", c)
    return c


def test_paced_calls_complete_and_measure(engine, clock):
    cfg = PacedCallConfig(n_calls=6, utterance_frames=16, duty=0.9,
                          measure_s=4.0, sla_ttfb_s=10.0)
    res = run_paced(Clocked(engine, clock), cfg)
    assert res.utterances >= 6  # every call spoke at least once
    assert res.audio_s > 0
    assert res.ttfb_p95 > 0
    # flow control: a call never buffers more than one utterance of audio;
    # aggregate audio is bounded by n_calls * duty * wall (+ slack for the
    # utterance granularity)
    assert res.audio_s <= cfg.n_calls * res.wall_s
    assert res.wall_s >= cfg.measure_s

    # the tiny 16-frame utterance on the tiny model must satisfy a loose SLA
    assert res.ok, (res.ttfb_p95, res.underruns)


def test_paced_calls_count_underruns_on_a_slow_clock(engine, clock):
    """Ticks of 100 ms for 8 ms of audio each: every utterance's second
    chunk comes after the first has played out and the grace is spent."""
    cfg = PacedCallConfig(n_calls=6, utterance_frames=16, duty=0.9,
                          measure_s=4.0, sla_ttfb_s=10.0)
    res = run_paced(Clocked(engine, clock, tick_s=0.1), cfg)
    assert res.utterances >= 6
    assert res.underruns >= res.utterances - cfg.n_calls
    assert not res.ok


def test_underrun_detection_clock():
    """_Call counts a chunk as underrun when it arrives after its play time."""
    import time as _time

    cfg = PacedCallConfig(grace_s=0.0)
    c = _Call(0, cfg, 0.0)
    c.state = "synth"
    c.utter_t0 = _time.monotonic()
    sr = cfg.sample_rate
    c.on_chunk(np.zeros(sr // 100, np.float32))  # 10 ms: starts playback
    assert len(c.ttfbs) == 1 and c.underruns == 0
    _time.sleep(0.05)  # playback outran the 10 ms buffer
    c.on_chunk(np.zeros(sr // 100, np.float32))
    assert c.underruns == 1
    c.on_chunk(None)
    assert c.state == "idle" and c.utterances == 1
    assert c.next_request_at > 0


def test_find_max_calls_stops_on_failure(engine, clock):
    base = PacedCallConfig(utterance_frames=16, duty=0.9, measure_s=2.0,
                           sla_ttfb_s=10.0)
    best, results = find_max_calls(Clocked(engine, clock), base, [2, 4])
    assert best is not None
    assert best.n_calls in (2, 4)
    assert len(results) <= 2


@pytest.fixture(scope="module")
def async_engine():
    eng = _engine(async_harvest=True)
    yield eng
    eng.close()


def test_async_harvest_paced_calls(async_engine, clock):
    """Async-harvest mode serves paced calls: the harvest thread hands out
    each tick's audio, stamped by the same clock."""
    cfg = PacedCallConfig(n_calls=6, utterance_frames=16, duty=0.9,
                          measure_s=4.0, sla_ttfb_s=10.0)
    res = run_paced(Clocked(async_engine, clock), cfg)
    assert res.utterances >= 6
    assert res.audio_s <= cfg.n_calls * res.wall_s
    assert res.ok, (res.ttfb_p95, res.underruns)


def test_async_harvest_session_completes_exactly(async_engine):
    got, done = [], []
    async_engine.start_session(
        np.asarray([3, 4, 5], np.int32), np.zeros(16, np.float32),
        lambda a: done.append(True) if a is None else got.append(len(a)),
        max_frames=24)
    while async_engine.step():
        pass
    assert done == [True]
    fs = async_engine.voc_cfg.total_upsample
    assert sum(got) == 24 * fs
