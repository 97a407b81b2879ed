"""Single-call echo-loop benchmark: RTP -> VAD -> STT -> TTS -> RTP.

A caller streams speech in as paced 20 ms G.711 RTP; the loop transcribes
each VAD segment and speaks the transcript straight back out the same leg.
The measured figure is the **echo latency**: time from the caller's
end-of-speech to the first synthesized packet leaving the pacer -- the sum
of VAD hangover + STT final-result latency + TTS first-frame latency +
pacing, i.e. the conversational turn latency a live-translation user
experiences.

Runs the REAL actor graph (RTPActor ingest/jitter/pacer + STTActor +
TTSActor engines); only SIP signalling is elided.

Usage:  python -m infernos_tpu_torch.bench.echo --tiny-real [--utterances 3]

Port of ``infernos_tpu/bench/echo.py`` on the port's actors and media
plane.  What differs, and why:

- ``run_echo`` places its actors on the card, or on ``device`` when the
  caller passes one (``device="cpu"`` in the tests), and takes the RTP
  port range its ``RTPActor`` allocates from (``rtp_ports``).
- After the last gap the caller keeps sending silence for up to
  ``SETTLE_S`` (60 s), until every utterance has its STT result and echoed
  audio has arrived after the last one; a healthy loop ends the wait at
  once.  The reference ends the call when the gap ends: a loaded host can
  take longer than the gap to answer, and the reference then reports an
  empty series, which measures the deadline, not the loop.
- ``main`` is new: it prints one JSON line of the report.  On the card it
  takes ``--tiny-real`` (``INFERNOS_MODEL_MODE=tiny-real``): the tiny
  random models' head dim (12) is not one the encoder attention kernel
  takes.
"""

from __future__ import annotations

import dataclasses
import time
import uuid as uuid_mod
from typing import List, Optional

import numpy as np

from ..audio.codecs import G711Codec
from ..cluster.actors import Actor, spawn
from ..cluster.model_actors import STTActor, TTSActor
from ..cluster.rtp_actor import RTPActor
from ..media.endpoint import RTPParams
from ..media.ingest import AudioInput
from ..media.rtp import RTPPacket, RTPPacketizer
from ..media.udp import UdpServer
from ..serving.sessions import STTRequest, TTSRequest

SETTLE_S = 60.0  # the caller's longest wait for the loop after the last gap


class EchoApp(Actor):
    """Bridges one RTP leg's VAD segments to STT and echoes text via TTS."""

    def __init__(self, rtp_actr, stt_actr, tts_actr, lang: str = "en"):
        self.rtp_actr = rtp_actr
        self.stt_actr = stt_actr
        self.tts_actr = tts_actr
        self.lang = lang
        self.rtp_sess_id = None
        self.handle = None  # bound right after spawn
        self.echo_times: List[float] = []  # STT-result arrival stamps

    def bind(self, handle) -> None:
        self.handle = handle

    def get_echo_times(self) -> List[float]:
        return list(self.echo_times)

    def start_call(self) -> tuple:
        """Returns (local RTP addr) after wiring the loop."""
        self.rtp_sess_id, laddr = self.rtp_actr.ask_sync(
            "new_rtp_session", RTPParams(rtp_target=None, codec=G711Codec, out_ptime=20))
        self.stt_sess_id = self.stt_actr.ask_sync("new_stt_session", False)
        self.tts_sess_id = self.tts_actr.ask_sync("new_tts_session")
        self.tts_actr.ask_sync(
            "tts_session_start", self.tts_sess_id,
            lambda chunk: self.rtp_actr.call(
                "rtp_session_soundout", self.rtp_sess_id, chunk))
        self.speaker_id = self.tts_actr.ask_sync("get_rand_voice_id")
        self.rtp_actr.ask_sync(
            "rtp_session_connect", self.rtp_sess_id,
            AudioInput(vad_chunk_in=lambda chunk: self.handle.call(
                "vad_chunk_in", chunk)))
        return laddr

    def set_target(self, addr) -> None:
        self.rtp_actr.ask_sync(
            "rtp_session_update", self.rtp_sess_id,
            RTPParams(rtp_target=addr, codec=G711Codec, out_ptime=20))

    def vad_chunk_in(self, chunk) -> None:
        self.stt_actr.call(
            "stt_session_soundin", self.stt_sess_id,
            STTRequest(chunk=chunk, lang=self.lang,
                       text_cb=lambda res: self.handle.call("text_in", res)))

    def text_in(self, res) -> None:
        self.echo_times.append(time.monotonic())
        text = res.text.strip() or "nothing heard"
        self.tts_actr.call(
            "tts_session_say", self.tts_sess_id,
            TTSRequest(text=text, speaker_id=self.speaker_id))

    def end_call(self) -> None:
        if self.rtp_sess_id is not None:
            self.rtp_actr.call("rtp_session_end", self.rtp_sess_id, True)
            self.stt_actr.call("stt_session_end", self.stt_sess_id)
            self.tts_actr.call("tts_session_end", self.tts_sess_id)


@dataclasses.dataclass
class EchoReport:
    utterances: int
    echo_latency_s: List[float]  # end-of-speech -> first echoed packet
    stt_latency_s: List[float]  # end-of-speech -> STT result
    rx_audio_s: float

    def p(self, series: List[float], q: float) -> float:
        s = sorted(series)
        return s[min(len(s) - 1, int(q * len(s)))] if s else 0.0


def _speechy(seconds: float, sr: int = 8000, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    return (0.35 * np.sin(2 * np.pi * 280 * t)
            * (1 + 0.2 * rng.standard_normal(len(t)))).astype(np.float32)


def run_echo(tiny: bool = True, utterances: int = 3,
             speech_s: float = 1.0, gap_s: float = 2.0,
             actors: Optional[tuple] = None, device=None,
             rtp_ports: tuple = (18000, 22000)) -> EchoReport:
    """Place one echo call and measure per-utterance turn latency."""
    own = actors is None
    if own:
        rtp = spawn(RTPActor, min_port=rtp_ports[0], max_port=rtp_ports[1],
                    device=device, name=f"rtp-echo-{uuid_mod.uuid4().hex[:6]}")
        stt = spawn(STTActor, tiny, device=device,
                    name=f"stt-echo-{uuid_mod.uuid4().hex[:6]}")
        tts = spawn(TTSActor, tiny, device=device,
                    name=f"tts-echo-{uuid_mod.uuid4().hex[:6]}")
        stt.ask_sync("start", timeout=600.0)
        tts.ask_sync("start", timeout=600.0)
    else:
        rtp, stt, tts = actors
    app = spawn(EchoApp, rtp, stt, tts,
                name=f"echo-app-{uuid_mod.uuid4().hex[:6]}")
    app.ask_sync("bind", app)
    codec = G711Codec()
    rx_stamps: List[tuple] = []  # (t, n_payload_bytes)

    def on_rx(data, addr, rtime):
        try:
            pkt = RTPPacket.parse(data)
            rx_stamps.append((time.monotonic(), pkt.payload))
        except Exception:
            pass

    sock = UdpServer(("127.0.0.1", 0), on_rx)
    try:
        laddr = app.ask_sync("start_call", timeout=600.0)
        app.ask_sync("set_target", sock.laddr)

        rs = RTPPacketizer(8000, 20)
        eos_times = []
        silence = np.zeros(160, np.float32)
        for u in range(utterances):
            audio = _speechy(speech_s, seed=u)
            for i in range(0, len(audio) - 159, 160):
                sock.send_to(rs.next_pkt(160, 0,
                                         codec.encode(audio[i:i + 160])),
                             laddr)
                time.sleep(0.02)
            eos_times.append(time.monotonic())
            # silence keeps the VAD/jitter clocks running (real phones
            # transmit comfort noise / silence frames)
            t_end = time.monotonic() + gap_s
            while time.monotonic() < t_end:
                sock.send_to(rs.next_pkt(160, 0, codec.encode(silence)), laddr)
                time.sleep(0.02)

        t_end = time.monotonic() + SETTLE_S
        while time.monotonic() < t_end and not (
                len(app.ask_sync("get_echo_times", timeout=10.0)) >= utterances
                and any(t > eos_times[-1] for t, _ in rx_stamps)):
            for _ in range(10):
                sock.send_to(rs.next_pkt(160, 0, codec.encode(silence)), laddr)
                time.sleep(0.02)
        stt_stamps = app.ask_sync("get_echo_times", timeout=10.0)
        echo_lat, stt_lat = [], []
        for eos in eos_times:
            # the pacer transmits only while audio is queued (idle gaps skip
            # the timestamp), so any packet after end-of-speech is echo
            first_rx = next((t for t, p in rx_stamps if t > eos), None)
            if first_rx is not None:
                echo_lat.append(first_rx - eos)
            first_stt = next((t for t in stt_stamps if t > eos), None)
            if first_stt is not None:
                stt_lat.append(first_stt - eos)
        rx_audio = sum(len(p) for _, p in rx_stamps) / 8000.0
        return EchoReport(utterances=utterances, echo_latency_s=echo_lat,
                          stt_latency_s=stt_lat, rx_audio_s=rx_audio)
    finally:
        app.call("end_call")
        sock.shutdown()
        if own:
            for h in (app, rtp, stt, tts):
                h.stop()


def main(argv=None) -> None:
    import argparse
    import json
    import os

    from ..cluster.actors import stop_all
    from ..utils.platform import default_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--utterances", type=int, default=3)
    ap.add_argument("--speech-s", type=float, default=1.0)
    ap.add_argument("--gap-s", type=float, default=2.0)
    ap.add_argument("--tiny-real", action="store_true",
                    help="serve the in-repo-trained tiny STT/TTS pair")
    args = ap.parse_args(argv)
    dev = default_device(os.environ.get("INFERNOS_DEVICE") or None)
    if dev.type == "cuda" and not args.tiny_real:
        ap.error("on the card the bench serves --tiny-real: the tiny random "
                 "models' head dim is not one the encoder attention kernel "
                 "takes")
    if args.tiny_real:
        os.environ["INFERNOS_MODEL_MODE"] = "tiny-real"
    try:
        rep = run_echo(tiny=True, utterances=args.utterances,
                       speech_s=args.speech_s, gap_s=args.gap_s, device=dev)
        print(json.dumps(dataclasses.asdict(rep)), flush=True)
    finally:
        stop_all()


if __name__ == "__main__":
    main()
