"""Paced RTP egress worker.

Capability parity with the reference's ``RTPOutputWorker``
(``RTP/RTPOutputWorker.py:84-155``): one thread per call leg pulls
``AudioChunk`` / markers from a queue into the multi-track muxer, encodes,
slices into exact ``ptime`` frames, synthesizes RTP headers, and paces with a
monotonic clock: target time accumulates as an exact ``Fraction`` so pacing
error never drifts; on idle ticks the sequence pauses and the timestamp
skips (``rsynth.skip(1)``, ``:107``).  ~100 ms of internal buffer absorbs
compute-plane jitter (``out_qsize``, ``:91``) -- the budget for the
accelerator's decode-step variance.

Python implementation (one thread per leg); the C++ engine replaces this
with a single timerfd loop for thousands of legs.
"""

from __future__ import annotations

import queue
import time
from fractions import Fraction
from typing import Callable, Optional, Union

from ..audio.chunk import AudioChunk
from ..audio.markers import ASMarkerGeneric
from ..audio.muxer import MTMuxer
from ..utils.threads import WrkThread
from .rtp import make_packetizer


class RTPOutputWorker(WrkThread):
    def __init__(self, codec, pkt_send: Callable[[bytes], None],
                 ptime_ms: int = 20, debug: bool = False):
        super().__init__(name="rtp-out")
        self.codec = codec
        self.pkt_send = pkt_send
        self.ptime_ms = ptime_ms
        self.samplerate_out = codec.srate
        self.data_queue: "queue.Queue" = queue.Queue()
        self.debug = debug
        self.sent_pkts = 0
        self.sent_bytes = 0
        self.data_log: Optional[list] = None
        self._rsynth = None  # set in run(); exposes the media-clock ts

    @property
    def rtp_ts(self) -> int:
        """Current RTP media-clock timestamp (advances across idle skips);
        the correct third element of an RTCP SR, unlike byte counters which
        freeze during silence and are codec-rate dependent."""
        # defensive getattr: the packetizer may be the Python RSynth or the
        # C++ NativePacketizer; both expose .ts, but never let a missing
        # attribute kill the (exception-swallowing) RTCP tick silently
        return getattr(self._rsynth, "ts", 0)

    def set_datalog(self, path: str) -> None:
        """Record all egress audio to a WAV at teardown (reference optional
        datalog, RTP/RTPOutputWorker.py:43-44,157-166)."""
        self.data_log = []
        self._dl_path = path

    def soundout(self, chunk: Union[AudioChunk, ASMarkerGeneric]):
        if isinstance(chunk, AudioChunk):
            assert len(chunk.audio) > 0
        self.data_queue.put(chunk)
        return (self.data_queue.qsize(), False)

    def end(self) -> None:
        self.stop(join=False)

    def run(self) -> None:
        out_pt = self.codec.ptype
        out_fsize = self.samplerate_out * self.ptime_ms // 1000  # samples/pkt
        ptime = Fraction(0)
        stime: Optional[float] = None
        rsynth = make_packetizer(self.codec.crate, self.ptime_ms)
        self._rsynth = rsynth
        qtimeout = Fraction(self.ptime_ms, 1000)
        # ~100 ms internal buffer rounded to frame size
        out_qsize = out_fsize * max(1, self.samplerate_out // 10 // out_fsize)
        mix = MTMuxer(self.samplerate_out, out_qsize)
        residual = b""
        while self.should_run():
            ctime = time.monotonic()
            try:
                item = self.data_queue.get(block=False)
            except queue.Empty:
                # idle tick: flush partial tails + fire drained markers
                # (reference mix.idle(), RTP/RTPOutputWorker.py:97)
                block = mix.get(flush=True)
                if block is None:
                    # idle: advance the schedule, skip ts, keep cadence
                    if stime is not None:
                        ptime += qtimeout
                        etime = ctime - stime
                        if ptime > etime:
                            time.sleep(float(ptime - etime))
                        rsynth.skip(1)
                    else:
                        time.sleep(float(qtimeout))
                    continue
            else:
                if item is None:
                    break
                mix.put(item)
                continue

            if stime is None:
                stime = ctime
            payload = residual + self.codec.encode(block)
            if self.data_log is not None:
                self.data_log.append(block)
            out_psize = self.codec.d2e_frames(out_fsize)
            while len(payload) >= out_psize:
                packet, payload = payload[:out_psize], payload[out_psize:]
                ptime += Fraction(out_fsize, self.samplerate_out)
                etime = ctime - stime
                pkt = rsynth.next_pkt(out_psize, out_pt, packet)
                self.sent_pkts += 1
                self.sent_bytes += out_psize
                self.pkt_send(pkt)
                if not self.should_run():
                    return
                if ptime > etime:
                    time.sleep(float(ptime - etime))
                    ctime = time.monotonic()
            residual = payload

    def on_stop(self) -> None:
        self.data_queue.put(None)
        if self.data_log:
            import numpy as _np

            from ..audio.chunk import AudioChunk as _AC

            _AC(_np.concatenate(self.data_log), self.samplerate_out).save_wav(
                self._dl_path)
