"""Native paced egress: ONE C++ timerfd/epoll loop for all call legs.

Replaces the Python thread-per-leg :class:`~.pacer.RTPOutputWorker` (which
mirrors the reference's per-leg sleep pacing,
``RTP/RTPOutputWorker.py:126-149``) with the C++ loop in
``csrc/rtp_engine.cpp``: Python mixes/encodes on the producer thread and
hands encoded payload bytes to the loop, which emits one RTP packet per
ptime on an absolute monotonic schedule for thousands of legs from a single
thread.  The Python worker remains the behavioural oracle; an endpoint uses
it only when ``INFERNOS_NATIVE_PACER=0`` asks for it (``media/endpoint.py``).

Marker semantics: :class:`ASMarkerSentDoneCB` fires when the loop's
``sent_bytes`` reaches the marker's byte offset -- i.e. when the packet
carrying the last pre-marker sample has actually left, matching the
reference's markers-travel-through-the-queue contract
(``Core/AStreamMarkers.py:17-31``).  A single watcher thread polls all
legs' pending markers.
"""

from __future__ import annotations

import atexit
import ctypes
import threading
from typing import Callable, List, Optional, Tuple, Union

import numpy as np

from ..audio.chunk import AudioChunk
from ..audio.markers import ASMarkerGeneric, ASMarkerSentDoneCB
from ..audio.muxer import MTMuxer
from ..utils.logging import get_logger
from . import native

log = get_logger("media.cpacer")

_loop_lock = threading.Lock()
_loop: Optional["NativePacerLoop"] = None


def available() -> bool:
    return native.available()


def shared_loop() -> "NativePacerLoop":
    """Process-wide pacer loop (one thread paces every leg)."""
    global _loop
    with _loop_lock:
        if _loop is None:
            _loop = NativePacerLoop()
        return _loop


def _close_shared_loop() -> None:
    """atexit: join the native pacer thread BEFORE libc teardown -- a live
    epoll thread during exit() intermittently aborts with
    'terminate called ... FATAL: exception not rethrown'."""
    global _loop
    with _loop_lock:
        if _loop is not None:
            try:
                _loop.close()
            except Exception:
                pass
            _loop = None


atexit.register(_close_shared_loop)


class NativePacerLoop:
    def __init__(self, idle_suspend_ticks: int = 250):
        self._lib = native._load()
        if self._lib is None:
            raise RuntimeError("native media engine unavailable")
        self._p = ctypes.c_void_p(self._lib.pacer_new(idle_suspend_ticks))
        self._legs: List["NativeLegWriter"] = []
        self._legs_lock = threading.Lock()
        self._watch = threading.Thread(target=self._watch_loop, daemon=True,
                                       name="cpacer-markers")
        self._stop = threading.Event()
        self._watch.start()

    def _watch_loop(self) -> None:
        while not self._stop.wait(0.01):
            with self._legs_lock:
                legs = [l for l in self._legs if l._pending_markers]
            for leg in legs:
                leg._fire_due_markers()

    def close(self) -> None:
        self._stop.set()
        self._watch.join(timeout=2.0)
        if self._p:
            self._lib.pacer_free(self._p)
            self._p = None

    def new_leg(self, codec, sock_fd: int, ptime_ms: int = 20,
                ssrc: Optional[int] = None) -> "NativeLegWriter":
        leg = NativeLegWriter(self, codec, sock_fd, ptime_ms, ssrc)
        with self._legs_lock:
            self._legs.append(leg)
        return leg

    def _drop(self, leg: "NativeLegWriter") -> None:
        with self._legs_lock:
            if leg in self._legs:
                self._legs.remove(leg)


class NativeLegWriter:
    """``RTPOutputWorker``-compatible writer backed by the native loop."""

    def __init__(self, loop: NativePacerLoop, codec, sock_fd: int,
                 ptime_ms: int, ssrc: Optional[int]):
        import random

        self.loop = loop
        self.codec = codec
        self.ptime_ms = ptime_ms
        self.samplerate_out = codec.srate
        self.out_fsize = codec.srate * ptime_ms // 1000  # samples/pkt
        self.frame_bytes = codec.d2e_frames(self.out_fsize)
        qsize = self.out_fsize * max(1, codec.srate // 10 // self.out_fsize)
        self._mux = MTMuxer(codec.srate, qsize)
        self._mux_lock = threading.Lock()
        self._written = 0  # encoded bytes handed to the loop
        self._pending_markers: List[Tuple[int, ASMarkerGeneric]] = []
        self.data_log: Optional[list] = None
        ssrc = ssrc if ssrc is not None else random.getrandbits(32)
        self.leg_id = loop._lib.pacer_add_leg(
            loop._p, sock_fd, codec.crate, ptime_ms, codec.ptype,
            self.frame_bytes,
            codec.crate * ptime_ms // 1000,  # RTP ts units per packet
            ssrc, random.getrandbits(16), random.getrandbits(30))
        self._ended = False

    # -- RTPOutputWorker-compatible surface ------------------------------------

    def start(self) -> None:  # the shared loop is already running
        pass

    def set_dest(self, addr: Tuple[str, int]) -> None:
        self.loop._lib.pacer_set_dest(self.loop._p, self.leg_id,
                                      addr[0].encode(), addr[1])

    def set_datalog(self, path: str) -> None:
        self.data_log = []
        self._dl_path = path

    def soundout(self, item: Union[AudioChunk, ASMarkerGeneric]):
        if self._ended:
            return (0, False)
        if isinstance(item, AudioChunk):
            assert len(item.audio) > 0
            with self._mux_lock:
                self._mux.put(item)
                self._drain_locked(flush=False)
        else:
            with self._mux_lock:
                self._drain_locked(flush=True)
                # pad to packet alignment so the marker's offset is reachable
                rem = self._written % self.frame_bytes
                if rem:
                    # silence() takes encoded-domain frame count (= bytes)
                    self._write_bytes(
                        self.codec.silence(self.frame_bytes - rem))
                self._pending_markers.append((self._written, item))
        return (0, False)

    def _drain_locked(self, flush: bool) -> None:
        while True:
            block = self._mux.get(flush=flush)
            if block is None:
                return
            if self.data_log is not None:
                self.data_log.append(block)
            self._write_bytes(self.codec.encode(block))
            if not flush:
                continue

    def _write_bytes(self, payload: bytes) -> None:
        if not payload:
            return
        buf = (ctypes.c_uint8 * len(payload)).from_buffer_copy(payload)
        self.loop._lib.pacer_write(self.loop._p, self.leg_id, buf,
                                   len(payload))
        self._written += len(payload)

    def _fire_due_markers(self) -> None:
        sent = self.loop._lib.pacer_leg_sent_bytes(self.loop._p, self.leg_id)
        due = []
        with self._mux_lock:
            while self._pending_markers and self._pending_markers[0][0] <= sent:
                due.append(self._pending_markers.pop(0)[1])
        for m in due:
            if isinstance(m, ASMarkerSentDoneCB):
                try:
                    m.on_proc()
                except Exception:
                    log.exception("marker callback failed")

    def stats(self) -> dict:
        out = (ctypes.c_uint64 * 10)()
        self.loop._lib.pacer_leg_stats(self.loop._p, self.leg_id, out)
        return {
            "sent_pkts": out[0], "skipped": out[1],
            "jit_le_500us": out[2], "jit_le_1ms": out[3],
            "jit_le_2ms": out[4], "jit_le_5ms": out[5], "jit_gt_5ms": out[6],
            "jit_max_ns": out[7], "sent_bytes": out[8],
            "rtp_ts": out[9],
        }

    def buffered_bytes(self) -> int:
        return int(self.loop._lib.pacer_leg_buffered(self.loop._p,
                                                     self.leg_id))

    def end(self) -> None:
        if self._ended:
            return
        self._ended = True
        if self.data_log:
            from ..audio.chunk import AudioChunk as _AC

            _AC(np.concatenate(self.data_log), self.samplerate_out).save_wav(
                self._dl_path)
        self.loop._lib.pacer_remove_leg(self.loop._p, self.leg_id)
        self.loop._drop(self)
