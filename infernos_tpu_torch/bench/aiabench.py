"""AIAttendant multi-call LLM benchmark.

N concurrent callers dial the attendant over real SIP; each speaks an
utterance and waits for the spoken LLM reply.  Measured per turn: **reply
latency** -- end-of-speech to the first reply packet on the caller's leg
(VAD + 2 s utterance flush + STT + LLM + TTS first frame + pacing).

Usage:  python -m infernos_tpu_torch.bench.aiabench [--calls 4] [--turns 2]
            (--full | --tiny-real)

Port of ``infernos_tpu/bench/aiabench.py`` on the port's SIP, media,
phone, config and ``main.build_cluster``.  What differs, and why:

- The cluster runs on the card, or on the CPU when ``INFERNOS_DEVICE=cpu``
  asks for it; without a card ``main`` raises before it binds a socket.
  On the card it takes ``--full`` or ``--tiny-real``: the tiny random
  models' head dim (12) is one the encoder attention kernel does not take.
- ``--full`` colocates an 8-slot whisper-large-v3 ``STTActor`` (8 and 16 s
  buckets) with the 7B int8 LLM and full TTS, in the serving dtype (bf16
  on the card), as the reference does on its chip.
- ``--turn-timeout`` puts ``run_aia_bench``'s ``turn_timeout`` on the
  command line (90 s, the reference's, by default): a turn the attendant
  chooses not to answer costs that long.  The default cannot be a
  tiny-real reply's few seconds: at ``--full`` every reply runs its whole
  token budget on the 7B LLM, about 11 s each on an H100 with several
  calls queued behind one engine, and a shorter wait would count real
  replies as failed turns.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import List

import numpy as np

from ..main import build_cluster
from .ltbench import _utterance, speechlang_utterance
from .phone import FakePhone

AIA_CONFIG = """
sip:
  settings:
    bind: 127.0.0.1:15992
  profiles:
    inbound:
      sink: apps/ai_attendant/bench
rtp:
  settings:
    min_port: 31000
    max_port: 32000
apps:
  ai_attendant:
    profiles:
      bench:
        stt_lang: en
        tts_lang: en
        llm_prompt: "You are a phone attendant. Be brief."
"""


@dataclasses.dataclass
class AIABenchResult:
    n_calls: int
    answered: int
    turns: int
    reply_p50_s: float
    reply_p95_s: float
    failures: int


def run_aia_bench(sip_bind, n_calls: int = 4, turns: int = 2,
                  utter_s: float = 1.4, turn_timeout: float = 90.0,
                  seed: int = 42, utter_fn=None) -> AIABenchResult:
    phones: List[FakePhone] = []
    try:
        for i in range(n_calls):
            p = FakePhone()
            try:
                p.call(sip_bind)
                phones.append(p)
            except Exception:
                p.close()
        answered = len(phones)
        latencies: List[float] = []
        failures = 0
        lock = threading.Lock()

        def run_call(pi: int, phone: FakePhone):
            nonlocal failures
            crng = np.random.default_rng(seed + 2000 + pi)
            for turn in range(turns):
                if utter_fn is not None:
                    utter = utter_fn(crng)
                    dur = len(utter) / 8000.0
                else:
                    utter = _utterance(crng, utter_s)
                    dur = utter_s
                n_before = len(phone.rx_packets)
                phone.stream_bg(utter, then_silence=True)  # silence: 2s flush
                t_eos = time.monotonic() + dur
                got = None
                deadline = t_eos + turn_timeout
                while time.monotonic() < deadline:
                    for (t, _d) in phone.rx_packets[n_before:]:
                        if t >= t_eos:
                            got = t
                            break
                    if got:
                        break
                    time.sleep(0.05)
                phone.stop_streaming()
                with lock:
                    if got is None:
                        failures += 1
                    else:
                        latencies.append(got - t_eos)
                time.sleep(1.0 + 0.3 * crng.random())

        thrs = [threading.Thread(target=run_call, args=(i, p), daemon=True)
                for i, p in enumerate(phones)]
        for t in thrs:
            t.start()
            time.sleep(0.15)
        for t in thrs:
            t.join(timeout=turns * (turn_timeout + utter_s + 3))
        for p in phones:
            try:
                p.hangup()
            except Exception:
                pass
        lat = sorted(latencies)
        p = lambda q: lat[min(len(lat) - 1, int(q * len(lat)))] if lat else 0.0
        return AIABenchResult(
            n_calls=n_calls, answered=answered, turns=len(lat),
            reply_p50_s=round(p(0.5), 3), reply_p95_s=round(p(0.95), 3),
            failures=failures)
    finally:
        for p in phones:
            p.close()


def main(argv=None) -> None:
    import argparse
    import tempfile

    from ..cluster.actors import stop_all
    from ..config import InfernConfig
    from ..utils.platform import default_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=4)
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--tiny-real", action="store_true",
                    help="serve the in-repo-trained tiny STT/LLM/TTS trio "
                         "and speak real speechlang intents")
    ap.add_argument("--turn-timeout", type=float, default=90.0,
                    help="seconds a turn waits for the reply's first packet")
    args = ap.parse_args(argv)
    dev = default_device(os.environ.get("INFERNOS_DEVICE") or None)
    if dev.type == "cuda" and not (args.full or args.tiny_real):
        ap.error("on the card the bench serves --full or --tiny-real: the "
                 "tiny random models' head dim is not one the encoder "
                 "attention kernel takes")
    if args.tiny_real:
        os.environ["INFERNOS_MODEL_MODE"] = "tiny-real"

    with tempfile.NamedTemporaryFile("w", suffix=".yaml", delete=False) as f:
        f.write(AIA_CONFIG)
        path = f.name
    iconf = InfernConfig(path)
    os.unlink(path)
    try:
        stt_actr = None
        if args.full:
            # colocated attendant: the card also carries the 7B-int8 LLM
            # and full TTS, so the STT engine runs a smaller footprint (8
            # slots, <= 16 s buckets)
            from ..cluster.actors import spawn
            from ..cluster.model_actors import STTActor
            from ..models.tiny_real import serving_dtype
            from ..serving.stt_engine import STTEngineConfig

            stt_actr = spawn(STTActor, tiny=False,
                             ecfg=STTEngineConfig(batch_slots=8, buckets_s=(8, 16),
                                                  dtype=serving_dtype(dev, tiny=False)),
                             device=dev, name="stt:aia-bench")
            stt_actr.ask_sync("start", timeout=1800)
        build_cluster(iconf, tiny=not args.full, bind_ip="127.0.0.1",
                      stt_actr=stt_actr, device=dev)
        r = run_aia_bench(iconf.sip_conf.bind, n_calls=args.calls,
                          turns=args.turns, turn_timeout=args.turn_timeout,
                          utter_fn=(speechlang_utterance if args.tiny_real
                                    else None))
        print(json.dumps(dataclasses.asdict(r)), flush=True)
    finally:
        stop_all()


if __name__ == "__main__":
    main()
