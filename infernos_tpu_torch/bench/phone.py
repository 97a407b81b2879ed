"""Scripted SIP+RTP endpoints for call-level benches and e2e tests.

``FakePhone`` originates calls (our own UAC + RTP socket), streams paced
G.711 and records replies; ``FarEnd`` auto-answers inbound calls (the role
of the B-leg callee).  Mirrors the reference's live-call smoke-test style
(SURVEY.md section 4) in scriptable form.
"""

from __future__ import annotations

import asyncio
import threading
import time
from typing import List, Optional, Tuple

import numpy as np

from ..audio.codecs import G711Codec
from ..media.rtp import RTPPacket, RTPPacketizer
from ..media.udp import UdpServer
from ..sip.message import SipURI
from ..sip.stack import SIPStack
from ..sip.ua import UAC, UAS


class FakePhone:
    """A scripted SIP+RTP endpoint playing caller audio and recording replies."""

    def __init__(self, loop: Optional[asyncio.AbstractEventLoop] = None,
                 stack: Optional[SIPStack] = None):
        self.codec = G711Codec()
        self.rx_packets: List[Tuple[float, bytes]] = []
        self._own_loop = loop is None
        if loop is None:
            self.loop = asyncio.new_event_loop()
            self._ready = threading.Event()
            self.stack = None
            self._thr = threading.Thread(target=self._run, daemon=True)
            self._thr.start()
            self._ready.wait(5.0)
        else:
            self.loop = loop
            self.stack = stack
        self.rtp_sock = UdpServer(("127.0.0.1", 0), self._rtp_in)
        self.remote_rtp = None
        self._streaming = False

    def _run(self):
        asyncio.set_event_loop(self.loop)

        async def boot():
            self.stack = SIPStack(("127.0.0.1", 0))
            await self.stack.start()
            self._ready.set()

        self.loop.run_until_complete(boot())
        self.loop.run_forever()

    def _rtp_in(self, data, addr, rtime):
        try:
            RTPPacket.parse(data)
            self.rx_packets.append((time.monotonic(), data))
        except Exception:
            pass

    def call(self, dest, cld="100", timeout=30.0, cli="fakephone"):
        """Call ``dest`` as caller ``cli`` (the From user the callee's apps
        see) to number ``cld``; returns the negotiated RTP parameters."""
        # ONE packetizer per call: RTP seq/ts must stay continuous across
        # talk spurts (the ingest jitter buffer asserts strict lseq)
        self._packetizer = RTPPacketizer(8000, 20)
        # offer ONLY G.711: the phone streams precomputed mu-law frames, so
        # advertising codecs it will not send (the UAC default adds G722)
        # would make the answerer negotiate one codec and receive another
        self.uac = UAC(self.stack, accept_codecs=(G711Codec,))
        fut = asyncio.run_coroutine_threadsafe(
            self.uac.invite_call(
                SipURI(host=dest[0], port=dest[1]), cld=cld,
                rtp_laddr=self.rtp_sock.laddr, codec=G711Codec, addr=dest,
                cli=cli),
            self.loop)
        params = fut.result(timeout)
        self.remote_rtp = params.rtp_target
        return params

    def stream_bg(self, audio: np.ndarray, then_silence: bool = True,
                  loop_audio: bool = False):
        """Stream paced 20 ms G.711; then silence (or loop) until stopped."""
        self._streaming = True

        def run():
            rs = self._packetizer
            i = 0
            silence = np.zeros(160, np.float32)
            next_t = time.monotonic()
            while self._streaming:
                if i + 160 <= len(audio):
                    frame = audio[i : i + 160]
                    i += 160
                elif loop_audio:
                    i = 0
                    continue
                elif then_silence:
                    frame = silence
                else:
                    break
                self.rtp_sock.send_to(
                    rs.next_pkt(160, 0, self.codec.encode(frame)),
                    self.remote_rtp)
                next_t += 0.02
                delay = next_t - time.monotonic()
                if delay > 0:
                    time.sleep(delay)

        t = threading.Thread(target=run, daemon=True)
        t.start()
        return t

    def stop_streaming(self):
        self._streaming = False

    def rx_audio(self) -> np.ndarray:
        if not self.rx_packets:
            return np.zeros(0, np.float32)
        return np.concatenate(
            [self.codec.decode(RTPPacket.parse(d).payload)
             for _, d in self.rx_packets])

    def rx_audio_since(self, n_packets: int) -> np.ndarray:
        """Decoded audio of packets received after the first ``n_packets``."""
        pkts = self.rx_packets[n_packets:]
        if not pkts:
            return np.zeros(0, np.float32)
        return np.concatenate(
            [self.codec.decode(RTPPacket.parse(d).payload) for _, d in pkts])

    def hangup(self):
        asyncio.run_coroutine_threadsafe(self.uac.bye(), self.loop).result(10.0)

    def close(self):
        self._streaming = False
        self.rtp_sock.shutdown()
        if self._own_loop:
            self.loop.call_soon_threadsafe(self.loop.stop)


class FarEnd:
    """Auto-answering callee (the B-leg 'phone')."""

    def __init__(self, port: int = 15880):
        self.codec = G711Codec()
        self.rx_packets: List[Tuple[float, bytes]] = []
        self.last_rtp_src = None  # framework media addr, learned from rx
        self._streaming = False
        self.loop = asyncio.new_event_loop()
        self._ready = threading.Event()
        self.answered = threading.Event()
        self.n_answered = 0
        self.rtp_sock = UdpServer(("127.0.0.1", 0), self._rtp_in)
        self.port = port
        self._thr = threading.Thread(target=self._run, daemon=True)
        self._thr.start()
        self._ready.wait(5.0)

    def _run(self):
        asyncio.set_event_loop(self.loop)

        async def boot():
            self.stack = SIPStack(("127.0.0.1", self.port))
            await self.stack.start()

            def on_invite(msg, addr):
                # answer G.711 only: this fake streams mu-law frames, so it
                # must not negotiate a wideband codec it will not send
                uas = UAS(self.stack, msg, addr,
                          accept_codecs=(G711Codec,))
                params = uas.negotiate()
                uas.accept(self.rtp_sock.laddr, params.codec)
                self.n_answered += 1
                self.answered.set()

            self.stack.on_invite = on_invite
            self._ready.set()

        self.loop.run_until_complete(boot())
        self.loop.run_forever()

    def _rtp_in(self, data, addr, rtime):
        try:
            RTPPacket.parse(data)
            self.rx_packets.append((time.monotonic(), data))
            self.last_rtp_src = addr
        except Exception:
            pass

    def rx_audio(self) -> np.ndarray:
        if not self.rx_packets:
            return np.zeros(0, np.float32)
        return np.concatenate(
            [self.codec.decode(RTPPacket.parse(d).payload)
             for _, d in self.rx_packets])

    def stream_bg(self, audio: np.ndarray, dest, then_silence: bool = True):
        """Paced 20 ms G.711 stream toward ``dest`` (the framework media
        address learned via ``last_rtp_src``); silence keeps the stream's
        lseq continuous until :meth:`stop_streaming`."""
        self._streaming = True
        rs = RTPPacketizer(8000, 20)

        def run():
            i = 0
            silence = np.zeros(160, np.float32)
            next_t = time.monotonic()
            while self._streaming:
                if i + 160 <= len(audio):
                    frame = audio[i : i + 160]
                    i += 160
                elif then_silence:
                    frame = silence
                else:
                    break
                self.rtp_sock.send_to(
                    rs.next_pkt(160, 0, self.codec.encode(frame)), dest)
                next_t += 0.02
                delay = next_t - time.monotonic()
                if delay > 0:
                    time.sleep(delay)

        t = threading.Thread(target=run, daemon=True)
        t.start()
        return t

    def stop_streaming(self):
        self._streaming = False

    def close(self):
        self._streaming = False
        self.rtp_sock.shutdown()
        self.loop.call_soon_threadsafe(self.loop.stop)
