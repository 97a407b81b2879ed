"""LiveTranslator two-leg multi-call benchmark (BASELINE.md config 4).

N concurrent callers (Alice_i) dial the LT profile over REAL SIP; the
framework dials a far-end (Bob_i) for each; every Alice speaks synthetic
utterances separated by listening gaps.  Measured per utterance: **turn
latency** -- Alice's end-of-speech to the first translated-TTS packet on
the matching Bob leg (VAD hangover + STT + translate + TTS first frame +
pacing), the conversational figure the north star is denominated in.

Usage:  python -m infernos_tpu_torch.bench.ltbench [--calls 4] [--turns 3]
            (--full | --tiny-real) [--ramp [--levels 1,2,4]]

Port of ``infernos_tpu/bench/ltbench.py`` on the port's SIP, media, codecs,
far-end phone, config and ``main.build_cluster``.  What differs, and why:

- The cluster runs on the card, or on the CPU when ``INFERNOS_DEVICE=cpu``
  asks for it; without a card ``main`` raises before it binds a socket.
  On the card it takes ``--full`` or ``--tiny-real``: the tiny random
  models' head dim (12) is one the encoder attention kernel does not take.
- The far ends' speech comes from the port's own copies of the tools'
  generators (``audio/synth_speech.py``, ``audio/speechlang.py``); there
  is no tone fallback.
- The default ramp ladder starts at one call (see ``main``), and the
  result carries no baseline ratio: the reference's figures were measured
  on other hardware.  The XLA compile cache has no counterpart here.
- ``INFERNOS_PYSAMPLER`` profiles the run as in the reference
  (``utils/pysampler.py``): the sampler starts with ``main``, is reset
  before the ramp's ladder (the levels are profiled, the boot is not) and
  dumps its report before the process's hard exit.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import os
import sys
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional

import numpy as np

from ..audio.codecs import G711Codec
from ..audio.resample import resample
from ..audio.speechlang import intent_utterance, render_text
from ..audio.synth_speech import synth_speech
from ..media.rtp import RTPPacket
from ..media.udp import UdpServer
from ..sip.stack import SIPStack
from ..sip.ua import UAS
from ..utils.metrics import metrics
from .phone import FakePhone


class MultiFarEnd:
    """Auto-answering callee with a FRESH RTP socket per inbound call, so
    each bridged call's B-leg audio is separable."""

    def __init__(self, port: int = 15990):
        self.codec = G711Codec()
        self.port = port
        self.calls: List[Dict] = []  # {"rx": [(t, bytes)], "sock": UdpServer}
        self._lock = threading.Lock()
        self.loop = asyncio.new_event_loop()
        self._ready = threading.Event()
        self._thr = threading.Thread(target=self._run, daemon=True)
        self._thr.start()
        self._ready.wait(5.0)

    def _run(self):
        asyncio.set_event_loop(self.loop)

        async def boot():
            self.stack = SIPStack(("127.0.0.1", self.port))
            await self.stack.start()

            def on_invite(msg, addr):
                entry = {"rx": [], "t_answer": time.monotonic()}

                def rx(data, a, rt, entry=entry):
                    try:
                        RTPPacket.parse(data)
                        entry["rx"].append((time.monotonic(), data))
                    except Exception:
                        pass

                sock = UdpServer(("127.0.0.1", 0), rx)
                entry["sock"] = sock
                # G.711 only: the fleet streams precomputed mu-law frames
                uas = UAS(self.stack, msg, addr, accept_codecs=(G711Codec,))
                params = uas.negotiate()
                uas.accept(sock.laddr, params.codec)
                with self._lock:
                    self.calls.append(entry)

            self.stack.on_invite = on_invite
            self._ready.set()

        self.loop.run_until_complete(boot())
        self.loop.run_forever()

    def n_calls(self) -> int:
        with self._lock:
            return len(self.calls)

    def close_calls(self, from_idx: int = 0) -> None:
        """Release B-leg sockets of finished calls (levels would otherwise
        accumulate hundreds of bound sockets across a ramp)."""
        with self._lock:
            for c in self.calls[from_idx:]:
                sock = c.pop("sock", None)
                if sock is not None:
                    sock.shutdown()

    def close(self):
        self.close_calls(0)
        self.loop.call_soon_threadsafe(self.loop.stop)


def _utterance(rng: np.random.Generator, seconds: float) -> np.ndarray:
    """Speech-like audio the trained VAD fires on (8 kHz)."""
    sp, _ = synth_speech(rng, seconds)
    return (0.4 * sp).astype(np.float32)


def speechlang_utterance(rng: np.random.Generator):
    """Real speechlang words rendered to 8 kHz G.711-band audio, for
    serving runs in tiny-real mode (trained STT/TTS/LLM): the pipeline's
    transcripts, replies and speech are then all real."""
    text = intent_utterance(rng)
    a16 = render_text(rng, text)
    a8 = np.asarray(resample(a16, 16000, 8000), np.float32).reshape(-1)
    return (0.5 * a8).astype(np.float32)


@dataclasses.dataclass
class LTBenchResult:
    n_calls: int
    answered: int
    turns: int
    turn_p50_s: float
    turn_p95_s: float
    failures: int  # turns with no reply within timeout


def run_lt_bench(sip_bind, far_end: MultiFarEnd, n_calls: int = 4,
                 turns: int = 3, utter_s: float = 1.6,
                 turn_timeout: float = 60.0, seed: int = 42,
                 utter_fn=None) -> LTBenchResult:
    """Drive ``n_calls`` concurrent LT calls; ``turns`` utterances each."""
    rng = np.random.default_rng(seed)
    phones: List[FakePhone] = []
    call_slot: Dict[int, int] = {}  # phone idx -> far-end call idx
    try:
        for i in range(n_calls):
            before = far_end.n_calls()
            p = FakePhone()
            p.call(sip_bind)
            # wait for the matching B leg (arrival-order pairing)
            deadline = time.monotonic() + 30.0
            while far_end.n_calls() <= before and time.monotonic() < deadline:
                time.sleep(0.05)
            if far_end.n_calls() <= before:
                p.close()
                continue
            call_slot[len(phones)] = before
            phones.append(p)

        answered = len(phones)
        latencies: List[float] = []
        failures = 0

        def run_call(pi: int, phone: FakePhone):
            nonlocal failures
            crng = np.random.default_rng(seed + 1000 + pi)
            entry = far_end.calls[call_slot[pi]]
            for turn in range(turns):
                # wait for B-leg quiescence (previous reply fully played)
                # so 'first packet after end-of-speech' measures THIS turn
                q_deadline = time.monotonic() + turn_timeout
                while time.monotonic() < q_deadline:
                    last = entry["rx"][-1][0] if entry["rx"] else 0.0
                    if time.monotonic() - last > 0.6:
                        break
                    time.sleep(0.1)
                if utter_fn is not None:
                    utter = utter_fn(crng)
                    dur = len(utter) / 8000.0
                else:
                    utter = _utterance(crng, utter_s)
                    dur = utter_s
                n_before = len(entry["rx"])
                phone.stream_bg(utter, then_silence=True)
                t_eos = time.monotonic() + dur  # end of speech
                # wait for first NEW B-leg packet after end-of-speech
                got = None
                deadline = t_eos + turn_timeout
                while time.monotonic() < deadline:
                    new = entry["rx"][n_before:]
                    for (t, _d) in new:
                        if t >= t_eos:
                            got = t
                            break
                    if got:
                        break
                    time.sleep(0.05)
                phone.stop_streaming()
                if got is None:
                    failures += 1
                else:
                    latencies.append(got - t_eos)
                time.sleep(0.5 + 0.2 * crng.random())  # listening gap

        thrs = [threading.Thread(target=run_call, args=(i, p), daemon=True)
                for i, p in enumerate(phones)]
        for t in thrs:
            t.start()
            time.sleep(0.15)  # stagger
        for t in thrs:
            t.join(timeout=turns * (turn_timeout + utter_s + 2))

        for p in phones:
            try:
                p.hangup()
            except Exception:
                pass
        lat = sorted(latencies)
        p = lambda q: lat[min(len(lat) - 1, int(q * len(lat)))] if lat else 0.0
        return LTBenchResult(
            n_calls=n_calls, answered=answered, turns=len(lat),
            turn_p50_s=round(p(0.5), 3), turn_p95_s=round(p(0.95), 3),
            failures=failures)
    finally:
        for p in phones:
            p.close()


# -- ramped fleet: the north-star metric --------------------------------------
#
# N concurrent two-leg calls with ONE shared SIP loop for every Alice and
# ONE pacer thread streaming every A-leg (pre-encoded G.711 frames), so the
# load generator stays lean enough to ramp into the dozens of calls on the
# same host that serves them.  Match: the reference's only scale test is
# the 48-pipe loopback QA fleet (Cluster/InfernBenchActor.py:236,257); this
# ramps REAL calls instead.

@dataclasses.dataclass
class LTLevelResult:
    n_calls: int
    answered: int
    turns_measured: int
    turn_p50_s: float
    turn_p95_s: float
    failures: int
    wall_s: float
    ok: bool


class _FleetCall:
    __slots__ = ("phone", "entry", "frames", "silence", "fi", "state",
                 "t_eos", "n_before", "deadline", "gap_until", "turns_left",
                 "lats", "failures", "rng", "t0")

    def __init__(self, phone, entry, turns, rng):
        self.t0 = time.monotonic()
        self.phone = phone
        self.entry = entry
        self.frames: List[bytes] = []
        self.silence = b"\xff" * 160  # G.711 u-law silence payload
        self.fi = 0
        self.state = "quiesce"
        self.t_eos = 0.0
        self.n_before = 0
        self.deadline = 0.0
        self.gap_until = 0.0
        self.turns_left = turns
        self.lats: List[float] = []
        self.failures = 0
        self.rng = rng


def _encode_frames(codec, audio: np.ndarray) -> List[bytes]:
    out = []
    for i in range(0, len(audio) - 159, 160):
        out.append(codec.encode(audio[i : i + 160]))
    return out


def run_lt_level(sip_bind, far_end: MultiFarEnd, n_calls: int,
                 turns: int = 2, utter_s: float = 1.6,
                 turn_timeout: float = 20.0, sla_turn_s: float = 3.5,
                 seed: int = 42) -> LTLevelResult:
    """One ramp level: place n_calls, run the turn state machine for all
    calls from a single pacer thread, tear down."""
    codec = G711Codec()
    rng = np.random.default_rng(seed)
    t_level = time.monotonic()
    first_idx = far_end.n_calls()

    # one shared SIP loop/stack for every Alice
    loop = asyncio.new_event_loop()
    ready = threading.Event()
    stack_box = {}

    def loop_main():
        asyncio.set_event_loop(loop)

        async def boot():
            stack_box["stack"] = SIPStack(("127.0.0.1", 0))
            await stack_box["stack"].start()
            ready.set()

        loop.run_until_complete(boot())
        loop.run_forever()

    lt = threading.Thread(target=loop_main, daemon=True)
    lt.start()
    ready.wait(5.0)

    calls: List[_FleetCall] = []
    try:
        for i in range(n_calls):
            before = far_end.n_calls()
            p = FakePhone(loop=loop, stack=stack_box["stack"])
            try:
                p.call(sip_bind, timeout=20.0)
            except Exception:
                p.close()
                continue
            deadline = time.monotonic() + 20.0
            while far_end.n_calls() <= before and time.monotonic() < deadline:
                time.sleep(0.02)
            if far_end.n_calls() <= before:
                p.close()
                continue
            crng = np.random.default_rng(seed + 1000 + i)
            calls.append(_FleetCall(p, far_end.calls[before], turns, crng))
        answered = len(calls)

        # pre-encode each call's utterance frames once
        for c in calls:
            c.frames = _encode_frames(codec, _utterance(c.rng, utter_s))

        # -- single pacer/state thread for the whole fleet -------------------
        stop = threading.Event()

        def fleet_loop():
            next_t = time.monotonic()
            while not stop.is_set():
                now = time.monotonic()
                done = 0
                for c in calls:
                    # pace: one frame per tick, always (silence keeps the
                    # jitter buffer's lseq continuous and feeds VAD silence)
                    if c.state == "speak" and c.fi < len(c.frames):
                        payload = c.frames[c.fi]
                        c.fi += 1
                        if c.fi >= len(c.frames):
                            c.state = "wait"
                            c.t_eos = now
                            c.deadline = now + turn_timeout
                    else:
                        payload = c.silence
                    try:
                        c.phone.rtp_sock.send_to(
                            c.phone._packetizer.next_pkt(160, 0, payload),
                            c.phone.remote_rtp)
                    except OSError:
                        pass
                    # state transitions (cheap; same thread)
                    if c.state == "quiesce":
                        rx = c.entry["rx"]
                        last = rx[-1][0] if rx else 0.0
                        if c.turns_left == 0:
                            c.state = "done"
                        elif now - last > 0.6 or now - c.t0 > 30.0:
                            c.state = "speak"
                            c.fi = 0
                            c.n_before = len(rx)
                    elif c.state == "wait":
                        # scan only NEW packets since last tick (a slice from
                        # n_before copied the turn's whole rx list every 20 ms
                        # x every call -- measurable at 32 calls on one core)
                        got = None
                        rx = c.entry["rx"]
                        while c.n_before < len(rx):
                            t = rx[c.n_before][0]
                            c.n_before += 1
                            if t >= c.t_eos:
                                got = t
                                break
                        if got is not None:
                            c.lats.append(got - c.t_eos)
                            c.turns_left -= 1
                            c.state = "gap"
                            c.gap_until = now + 0.5 + 0.2 * c.rng.random()
                        elif now > c.deadline:
                            c.failures += 1
                            c.turns_left -= 1
                            c.state = "gap"
                            c.gap_until = now + 0.2
                    elif c.state == "gap":
                        if now >= c.gap_until:
                            c.state = "done" if c.turns_left == 0 else "quiesce"
                            if c.state == "quiesce":
                                # next turn gets fresh audio
                                c.frames = _encode_frames(
                                    codec, _utterance(c.rng, utter_s))
                    if c.state == "done":
                        done += 1
                if done == len(calls):
                    break
                next_t += 0.02
                delay = next_t - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
                elif delay < -1.0:
                    next_t = time.monotonic()  # fell behind; resync

        fl = threading.Thread(target=fleet_loop, daemon=True)
        fl.start()
        fl.join(timeout=30.0 + turns * (turn_timeout + utter_s + 2.0))
        stop.set()

        # engine-stage snapshot to stderr: where did this level's turn time
        # go (STT inference, TTS TTFB/queue, engine tick cadence)?
        try:
            snap = metrics.snapshot()
            keys = [k for k in snap
                    if k.startswith(("stt.inf_time", "stt.queue", "tts.ttfb",
                                     "tts.queue_wait", "tts.tick_s"))
                    and (k.endswith(".p50") or k.endswith(".p95")
                         or k.endswith(".count"))]
            sys.stderr.write("level %d engine metrics: %s\n" % (
                n_calls, {k: round(snap[k], 3) for k in sorted(keys)}))
        except Exception:
            pass
        lats = sorted(x for c in calls for x in c.lats)
        failures = sum(c.failures for c in calls)
        p = lambda q: lats[min(len(lats) - 1, int(q * len(lats)))] if lats else 0.0
        ok = (answered == n_calls and failures == 0 and len(lats) > 0
              and p(0.95) <= sla_turn_s)
        return LTLevelResult(
            n_calls=n_calls, answered=answered, turns_measured=len(lats),
            turn_p50_s=round(p(0.5), 3), turn_p95_s=round(p(0.95), 3),
            failures=failures, wall_s=round(time.monotonic() - t_level, 1),
            ok=ok)
    finally:
        for c in calls:
            try:
                c.phone.hangup()
            except Exception:
                pass
        for c in calls:
            c.phone.close()
        far_end.close_calls(first_idx)
        loop.call_soon_threadsafe(loop.stop)
        time.sleep(1.0)  # let teardown drain before the next level


def run_lt_ramp(sip_bind, far_end: MultiFarEnd, levels: List[int],
                turns: int = 2, utter_s: float = 1.6,
                sla_turn_s: float = 3.5, seed: int = 42,
                on_level: Optional[Callable] = None):
    """Ramp the fleet through ``levels`` until the SLA breaks; one retry
    per failed level (host clocks vary between runs).  ``on_level(best,
    results)`` fires after every completed level so callers can publish
    progressive results (a killed ramp still records its best passing
    level)."""
    results = []
    best: Optional[LTLevelResult] = None
    for n in levels:
        r = run_lt_level(sip_bind, far_end, n, turns=turns, utter_s=utter_s,
                         sla_turn_s=sla_turn_s, seed=seed)
        results.append(r)
        if not r.ok:
            if on_level is not None:
                on_level(best, results)
            r = run_lt_level(sip_bind, far_end, n, turns=turns,
                             utter_s=utter_s, sla_turn_s=sla_turn_s,
                             seed=seed + 17)
            results.append(r)
        if r.ok:
            best = r
        if on_level is not None:
            on_level(best, results)
        if not r.ok:
            break
    return best, results


FAR_END_PORT = 15990
LT_CONFIG = f"""
sip:
  settings:
    bind: 127.0.0.1:15991
  profiles:
    inbound:
      sink: apps/live_translator/bench
    bob:
      sip_server: 127.0.0.1:{FAR_END_PORT}
rtp:
  settings:
    min_port: 30000
    max_port: 31000
apps:
  live_translator:
    profiles:
      bench:
        stt_langs: ['en', 'pt']
        tts_langs: ['pt', 'en']
        outbound: sip/bob;cld=900
"""

# The card's ladder starts at one call: the port's first measurements put
# a second segment's STT near the 3.5 s limit already at two calls (the
# reference's default, 16-40 calls, came from its own hardware's records).
# It doubles to 16, then climbs by 8 to 32, the TTS engine's most slots on
# the card.  BENCH_LT_LEVELS or --levels override it.
DEFAULT_LEVELS = "1,2,4,8,16,24,32"


def main(argv=None) -> None:
    import argparse
    import tempfile

    from ..cluster.actors import stop_all
    from ..config import InfernConfig
    from ..main import build_cluster
    from ..utils.platform import default_device
    from ..utils.pysampler import maybe_start_from_env

    maybe_start_from_env()  # INFERNOS_PYSAMPLER=prof.json to profile
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=4)
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--tiny-real", action="store_true",
                    help="serve the in-repo-trained tiny STT/TTS/LLM and "
                         "speak real speechlang utterances (measured, not "
                         "extrapolated, turn latency)")
    ap.add_argument("--ramp", action="store_true",
                    help="ramp N concurrent calls until the turn SLA breaks "
                         "and report lt_calls_per_chip (the north-star)")
    ap.add_argument("--levels", default="",
                    help="comma-separated ramp ladder (default "
                         "BENCH_LT_LEVELS or %s)" % DEFAULT_LEVELS)
    ap.add_argument("--sla", type=float, default=3.5,
                    help="p95 turn-latency SLA seconds")
    args = ap.parse_args(argv)
    dev = default_device(os.environ.get("INFERNOS_DEVICE") or None)
    if dev.type == "cuda" and not (args.full or args.tiny_real):
        ap.error("on the card the bench serves --full or --tiny-real: the "
                 "tiny random models' head dim is not one the encoder "
                 "attention kernel takes")

    with tempfile.NamedTemporaryFile("w", suffix=".yaml", delete=False) as f:
        f.write(LT_CONFIG)
        path = f.name
    iconf = InfernConfig(path)
    os.unlink(path)
    if args.tiny_real:
        os.environ["INFERNOS_MODEL_MODE"] = "tiny-real"
    far = MultiFarEnd(port=FAR_END_PORT)
    rc = 0
    try:
        t0 = time.monotonic()
        build_cluster(iconf, tiny=not args.full, bind_ip="127.0.0.1", device=dev)
        startup_s = time.monotonic() - t0
        if args.ramp:
            levels = [int(x) for x in (args.levels or os.environ.get(
                "BENCH_LT_LEVELS", DEFAULT_LEVELS)).split(",")]

            def _ramp_json(best, results):
                return {
                    "metric": "lt_calls_per_chip",
                    "value": best.n_calls if best else 0,
                    "unit": f"concurrent two-leg LT calls "
                            f"(p95 turn<{args.sla}s, 0 failed turns)",
                    "detail": {
                        "turn_p50_s": best.turn_p50_s if best else None,
                        "turn_p95_s": best.turn_p95_s if best else None,
                        "startup_s": round(startup_s, 1),
                        "levels": [dataclasses.asdict(r) for r in results],
                    },
                }

            def _on_level(best, results):
                # progressive publication: if the ramp is killed mid-ladder,
                # the last stdout JSON line is the freshest passing level
                print(json.dumps(_ramp_json(best, results)), flush=True)

            from ..utils import pysampler as _ps

            if _ps._auto is not None:  # profile the LEVELS, not the boot
                _ps._auto.reset()
            best, results = run_lt_ramp(
                iconf.sip_conf.bind, far, levels, turns=args.turns,
                sla_turn_s=args.sla, on_level=_on_level)
            print(json.dumps(_ramp_json(best, results)), flush=True)
        else:
            r = run_lt_bench(iconf.sip_conf.bind, far, n_calls=args.calls,
                             turns=args.turns,
                             utter_fn=(speechlang_utterance if args.tiny_real
                                       else None))
            out = dataclasses.asdict(r)
            out["startup_s"] = round(startup_s, 1)
            print(json.dumps(out))
    except BaseException:  # reported, then the exit below ends the process
        traceback.print_exc()
        rc = 1
    finally:
        # Hard exit after the result line is out: the native pacer's
        # threads must not be able to turn a finished run into a failed
        # exit at interpreter teardown.
        sys.stdout.flush()
        sys.stderr.flush()
        try:
            # os._exit skips atexit: flush the profiler dump (if any) by hand
            from ..utils.pysampler import _auto as _sampler

            if _sampler is not None:
                _sampler.stop()
                _sampler.dump(os.environ["INFERNOS_PYSAMPLER"])
        except Exception:
            traceback.print_exc()
        try:
            stop_all()
            far.close()
        except Exception:
            traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(rc)


if __name__ == "__main__":
    main()
