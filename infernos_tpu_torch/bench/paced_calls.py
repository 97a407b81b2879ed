"""Paced concurrent-call TTS benchmark: the north-star product shape.

The reference's ``bench/ttsbench.py`` measures aggregate
audio-sec/wall-sec (throughput equivalent); THIS bench measures what BASELINE.md is denominated in --
**N concurrent paced calls per chip** with an SLA on first-frame latency.

A *paced call* consumes audio at exactly 1x real time (one 20 ms RTP packet
per 20 ms, the reference's ``RTP/RTPOutputWorker.py:126-149``).  A call
speaks in utterances (sentences); the next utterance is only requested when
the previous has *finished playing* plus a listening gap -- the reference
gets the same flow control from ``tts_say_done`` markers traveling through
the pacer queue (``Cluster/TTSSession.py:104-125``).  Each utterance
occupies an engine slot only while synthesizing (~1/10 of its audio
duration at measured per-slot speed), so B fast slots serve many slow
calls: utterance-level slot multiplexing.

Pacing is modeled analytically against the monotonic clock (playback starts
at first chunk; an underrun is a chunk arriving after its scheduled play
time).  Generation is real; only the UDP socket is elided.

Port of ``infernos_tpu/bench/paced_calls.py``, unchanged: numpy and the
TTS engine's session API (``start_session``, ``step``), which the port's
``serving/tts_engine.py`` keeps.

Reported per load level:
- ``ttfb_p95``: utterance request -> first audio chunk available.
- ``underruns``: chunks that arrived after the pacer needed them
  (late > 60 ms grace, three packet times).
- pass = p95 TTFB < SLA and no underruns.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class PacedCallConfig:
    n_calls: int = 100
    utterance_frames: int = 128  # ~2.05 s audio per utterance (16 ms/frame)
    duty: float = 0.5  # fraction of call time spent speaking (LT: ~<=0.5)
    sla_ttfb_s: float = 0.2  # BASELINE.md north star: p95 < 200 ms
    grace_s: float = 0.06  # late-chunk grace: 3 packet times of jitter buffer
    measure_s: float = 20.0
    sample_rate: int = 16000
    seed: int = 42


class _Call:
    __slots__ = ("idx", "state", "next_request_at", "utter_t0", "play_start",
                 "buffered_s", "ttfbs", "underruns", "utterances", "cfg")

    def __init__(self, idx: int, cfg: PacedCallConfig, first_at: float):
        self.idx = idx
        self.cfg = cfg
        self.state = "idle"  # idle -> synth -> idle ...
        self.next_request_at = first_at
        self.utter_t0 = 0.0
        self.play_start = 0.0
        self.buffered_s = 0.0
        self.ttfbs: List[float] = []
        self.underruns = 0
        self.utterances = 0

    def on_chunk(self, audio: Optional[np.ndarray]) -> None:
        now = time.monotonic()
        cfg = self.cfg
        if audio is None:  # utterance done synthesizing
            self.state = "idle"
            self.utterances += 1
            play_end = self.play_start + self.buffered_s
            listen_s = self.buffered_s * (1.0 - cfg.duty) / max(cfg.duty, 1e-6)
            self.next_request_at = max(play_end, now) + listen_s
            return
        if self.buffered_s == 0.0:  # first chunk of this utterance
            self.ttfbs.append(now - self.utter_t0)
            self.play_start = now
        else:
            # pacer wanted this chunk at play_start + buffered_s
            due = self.play_start + self.buffered_s + cfg.grace_s
            if now > due:
                self.underruns += 1
        self.buffered_s += len(audio) / cfg.sample_rate


@dataclasses.dataclass
class PacedResult:
    n_calls: int
    utterances: int
    ttfb_p50: float
    ttfb_p95: float
    underruns: int
    audio_s: float
    wall_s: float
    ok: bool


def run_paced(engine, cfg: PacedCallConfig,
              make_utterance=None) -> PacedResult:
    """Drive ``cfg.n_calls`` paced calls through a running TTSEngine."""
    rng = np.random.default_rng(cfg.seed)
    vocab = engine.cfg.vocab_size
    spk_dim = engine.cfg.speaker_embedding_dim

    if make_utterance is None:
        def make_utterance():
            ids = rng.integers(2, vocab, size=int(rng.integers(16, 48)))
            return ids.astype(np.int32)

    t0 = time.monotonic()
    # stagger call starts uniformly over one speak+listen cycle so arrivals
    # are unsynchronized (as in production) and load is flat from the start
    frame_s = engine.voc_cfg.total_upsample / cfg.sample_rate
    cycle_s = cfg.utterance_frames * frame_s / max(cfg.duty, 1e-6)
    calls = [_Call(i, cfg, t0 + rng.uniform(0.0, cycle_s))
             for i in range(cfg.n_calls)]
    spks = [rng.standard_normal(spk_dim).astype(np.float32)
            for _ in range(min(cfg.n_calls, 64))]

    deadline = t0 + cfg.measure_s
    audio_samples = [0]

    def start_utterance(call: _Call) -> None:
        call.state = "synth"
        call.buffered_s = 0.0
        call.utter_t0 = time.monotonic()

        def cb(a, call=call):
            if a is not None:
                audio_samples[0] += len(a)
            call.on_chunk(a)

        engine.start_session(make_utterance(), spks[call.idx % len(spks)],
                             cb, max_frames=cfg.utterance_frames)

    while time.monotonic() < deadline:
        now = time.monotonic()
        for c in calls:
            if c.state == "idle" and now >= c.next_request_at:
                start_utterance(c)
        if not engine.step():
            # nothing active: sleep until the next scheduled utterance
            nxt = min((c.next_request_at for c in calls if c.state == "idle"),
                      default=now + 0.005)
            time.sleep(min(max(nxt - time.monotonic(), 0.0), 0.005))
    # drain in-flight utterances so their chunks don't leak into nothing
    while engine.step():
        pass

    wall = time.monotonic() - t0
    ttfbs = sorted(t for c in calls for t in c.ttfbs)
    utts = sum(c.utterances for c in calls)
    underruns = sum(c.underruns for c in calls)
    p = lambda q: ttfbs[min(len(ttfbs) - 1, int(q * len(ttfbs)))] if ttfbs else 0.0
    ok = bool(ttfbs) and p(0.95) < cfg.sla_ttfb_s and underruns == 0
    return PacedResult(
        n_calls=cfg.n_calls, utterances=utts, ttfb_p50=p(0.50),
        ttfb_p95=p(0.95), underruns=underruns,
        audio_s=audio_samples[0] / cfg.sample_rate, wall_s=wall, ok=ok,
    )


def find_max_calls(engine, base: PacedCallConfig,
                   candidates: List[int]) -> tuple:
    """Measure ascending call counts; return (best_passing_result, all)."""
    results = []
    best = None
    for n in candidates:
        cfg = dataclasses.replace(base, n_calls=n)
        r = run_paced(engine, cfg)
        results.append(r)
        if r.ok:
            best = r
        else:
            break
    return best, results
