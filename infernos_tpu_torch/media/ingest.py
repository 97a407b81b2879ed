"""RTP ingest ring: one thread per media-plane process feeding VAD.

Capability parity with ``RTP/InfernRTPIngest.py``: a single worker thread
consumes a global packet queue of work items (packet / stream-update /
stream-connect), owns the batched VAD worker, and per stream runs the
jitter buffer, fills ERS gaps with codec silence, enforces strict lseq
ordering, and feeds payload bytes to the VAD channel
(``InfernRTPIngest.py:76-98,113-158``).

``AudioInput`` callbacks may be UUIDs resolved to direct in-process soundout
functions at connect time -- the RTP-to-RTP fast path that bypasses RPC for
bridged legs (``InfernRTPIngest.py:58-60``, ``Cluster/InfernRTPActor.py:67-69``).
"""

from __future__ import annotations

import os
import queue
import threading
import uuid as uuid_mod
from dataclasses import dataclass
from typing import Callable, Optional, Union

from ..audio.chunk import AudioChunk
from ..models import vad as vad_m
from ..serving.vad_engine import VADChannel, VADWorker
from ..utils.logging import get_logger
from ..utils.platform import default_device
from ..utils.threads import WrkThread
from .jitter import RTPFrameType, make_jitter_buffer
from .rtp import RTPParseError

log = get_logger("media.ingest")


@dataclass
class AudioInput:
    """Pair of stream callbacks; values may be UUIDs resolved at connect."""

    audio_in: Optional[Union[Callable, uuid_mod.UUID]] = None
    vad_chunk_in: Optional[Union[Callable, uuid_mod.UUID]] = None


class _WIPkt:
    __slots__ = ("stream", "data", "address", "rtime")

    def __init__(self, stream, data, address, rtime):
        self.stream, self.data, self.address, self.rtime = stream, data, address, rtime


class _WIStreamUpdate:
    __slots__ = ("stream",)

    def __init__(self, stream):
        self.stream = stream


class _WIStreamConnect:
    __slots__ = ("stream", "ain")

    def __init__(self, stream, ain):
        self.stream, self.ain = stream, ain


class RTPInStream:
    """Per-leg inbound stream: jitter buffer -> codec gap fill -> VAD."""

    jb_size = 8

    def __init__(self, ring: "RTPIngest", codec,
                 get_direct_soundout: Optional[Callable] = None,
                 input_sr: int = 8000):
        self.ring = ring
        self.codec = codec
        self.get_direct_soundout = get_direct_soundout
        self.jbuf = make_jitter_buffer(self.jb_size)
        self.last_output_lseq: Optional[int] = None
        self.npkts = 0
        self.pt_dropped = 0
        self.ain = AudioInput()
        self.ain_lock = threading.Lock()
        self.vchan = VADChannel(self._audio_chunk_out, self._vad_chunk_out,
                                codec, sample_rate=input_sr)

    # -- producer side (UDP thread) -----------------------------------------
    def rtp_received(self, data: bytes, address, rtime: float) -> None:
        self.ring.pkt_queue.put(_WIPkt(self, data, address, rtime))

    def release(self) -> None:
        """Free this stream's VAD model-state slot (call at leg teardown --
        the worker has a bounded slot table)."""
        self.ring.vad_worker.release_channel(self.vchan)

    def stream_update(self) -> None:
        self.ring.pkt_queue.put(_WIStreamUpdate(self))

    def stream_connect(self, ain: AudioInput) -> None:
        if isinstance(ain.vad_chunk_in, uuid_mod.UUID):
            ain.vad_chunk_in = self.get_direct_soundout(ain.vad_chunk_in)
        if isinstance(ain.audio_in, uuid_mod.UUID):
            ain.audio_in = self.get_direct_soundout(ain.audio_in)
        self.ring.pkt_queue.put(_WIStreamConnect(self, ain))

    # -- ring thread ---------------------------------------------------------
    def _proc(self, wi, vad_worker: VADWorker) -> None:
        if isinstance(wi, _WIStreamUpdate):
            # re-INVITE: fresh jitter buffer + sequence state
            self.jbuf = make_jitter_buffer(self.jb_size)
            self.last_output_lseq = None
            return
        if isinstance(wi, _WIStreamConnect):
            with self.ain_lock:
                self.ain = wi.ain
            return
        # -- payload-type discipline (be liberal in what you accept) ---------
        # Some endpoints answer-negotiate one codec then send another they
        # also support (observed: offer lists PCMU first, our answer prefers
        # G722, the peer streams PCMU anyway).  Decoding PCMU bytes as G722
        # ADPCM yields loud envelope-tracking garbage that poisons VAD+STT,
        # so: on the FIRST audio packet, follow the sender's pt if we
        # support it; after that, drop any packet whose pt does not match
        # the stream codec (comfort-noise/DTMF/late flips must not reach
        # the decoder).  Reference ingest trusts rtpsynth's pt handling
        # (RTP/InfernRTPIngest.py:76-98); this is the explicit equivalent.
        if len(wi.data) >= 12:
            pt = wi.data[1] & 0x7F
            if pt != self.codec.ptype:
                from ..audio.codecs import CODECS

                if self.npkts == 0 and pt in CODECS:
                    log.warning(
                        "stream %r: peer sends pt %d (%s) instead of "
                        "negotiated %s; following the sender", self, pt,
                        CODECS[pt].ename, self.codec.ename)
                    self.codec = CODECS[pt]()
                    self.vchan.rebind_codec(self.codec)
                else:
                    self.pt_dropped += 1
                    if self.pt_dropped == 1:
                        log.warning(
                            "stream %r: dropping packets with unexpected "
                            "pt %d (negotiated %s)", self, pt,
                            self.codec.ename)
                    return
        try:
            frames = self.jbuf.udp_in(wi.data)
        except RTPParseError:
            return
        self.npkts += 1
        dump = os.environ.get("INFERNOS_DUMP_RTP")
        for f in frames:
            if f.type == RTPFrameType.ERS:
                self.last_output_lseq = f.lseq_end
                payload = self.codec.silence(f.ts_diff)
            else:
                assert (self.last_output_lseq is None
                        or f.lseq == self.last_output_lseq + 1), \
                    (f.lseq, self.last_output_lseq)
                self.last_output_lseq = f.lseq
                payload = f.rtp_data
            if dump:  # debugging aid: append (kind, lseq, payload) records
                with open(os.path.join(
                        dump, f"rtp_{id(self):x}.bin"), "ab") as df:
                    kind = b"E" if f.type == RTPFrameType.ERS else b"A"
                    df.write(kind + len(payload).to_bytes(4, "little")
                             + int(f.lseq).to_bytes(8, "little", signed=True)
                             + payload)
            self.vchan.ingest(vad_worker, payload)

    # -- VAD callbacks (worker thread) ---------------------------------------
    def _audio_chunk_out(self, chunk: AudioChunk, active: bool) -> None:
        chunk.active = active
        with self.ain_lock:
            cb = self.ain.audio_in
        if cb is not None:
            cb(chunk)

    def _vad_chunk_out(self, chunk) -> None:
        with self.ain_lock:
            cb = self.ain.vad_chunk_in
        if cb is not None:
            cb(chunk)


def default_vad_factory(batch: int, device=None):
    """The trained VAD (the reference's Silero role,
    ``Core/VAD/SileroVAD.py:44-45``; ours is trained by
    ``tools/train_vad.py`` on synthetic telephone audio) as a
    :class:`~..models.vad.NeuralVAD` on ``default_device(device)``: the card
    unless the caller asks for the CPU.  The host ``NumpyVAD`` and
    ``EnergyVAD`` stay explicit factories; without the vendored checkpoint
    this raises rather than serve another model."""
    dev = default_device(device)
    params = vad_m.load_pretrained(dev)
    if params is None:
        raise RuntimeError("vendored VAD weights (vad_weights.npz) missing")
    return vad_m.NeuralVAD(params, vad_m.VADConfig(), batch, device=dev)


class RTPIngest(WrkThread):
    """The shared ingest ring thread (one per media-plane process)."""

    def __init__(self, vad_model_factory: Optional[Callable[[int], object]] = None,
                 window: int = 768, device=None):
        """``vad_model_factory(batch)`` builds the VAD model; by default
        :func:`default_vad_factory` on ``device`` (the card unless given)."""
        super().__init__(name="rtp-ingest")
        self.pkt_queue: "queue.Queue" = queue.Queue()
        if vad_model_factory is None:
            dev = default_device(device)
            vad_model_factory = lambda batch: default_vad_factory(batch, dev)  # noqa: E731
        self.vad_worker = VADWorker(vad_model_factory, window=window)

    def start(self) -> None:
        self.vad_worker.start()
        super().start()

    def run(self) -> None:
        while self.should_run():
            wi = self.pkt_queue.get()
            if wi is None:
                break
            # the ring is SHARED by every live call: one malformed stream
            # (jbuf assert, codec error) must not kill the whole media plane
            try:
                wi.stream._proc(wi, self.vad_worker)
            except Exception:
                log.exception("ingest work item failed; stream %r continues",
                              wi.stream)

    def on_stop(self) -> None:
        self.pkt_queue.put(None)

    def stop(self, join: bool = True) -> None:
        super().stop(join=join)
        self.vad_worker.stop(join=join)
