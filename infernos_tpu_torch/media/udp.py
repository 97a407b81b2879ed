"""UDP transport + RTP port allocation.

Capability parity: replaces sippy's ``Udp_server`` (used at
``RTP/InfernRTPEPoint.py:31-35`` with ``nworkers=1, direct_dispatch=True``)
and ``RTP_port_allocator`` (``RTP/InfernRTPConf.py:5-19``).

The reference binds one worker thread per socket; at LT-ramp scale that is
~3 Python threads per call (RTP A/B legs + RTCP) all waking the GIL at
50 pps each -- at 32 calls the single bench host core spent more time
scheduling recv threads than doing work.  All ``UdpServer`` receive paths
therefore share ONE epoll selector thread (the C++ engine's design for the
egress side, ``native/rtp_engine.cpp pacer_loop``); per-socket callbacks
must stay O(packet) cheap (they only enqueue into the ingest ring /
result lists).  ``INFERNOS_UDP_THREADS=1`` restores thread-per-socket.
"""

from __future__ import annotations

import os
import random
import selectors
import socket
import threading
import time
from collections import deque
from typing import Callable, Optional, Tuple


class _SelectorLoop:
    """Process-wide epoll loop shared by every UdpServer receive path.

    (Un)registrations are marshalled onto the loop thread via a wake
    socketpair -- ``selectors`` objects are not safe to mutate during
    ``select()`` from other threads.
    """

    _instance: Optional["_SelectorLoop"] = None
    _ilock = threading.Lock()

    @classmethod
    def get(cls) -> "_SelectorLoop":
        with cls._ilock:
            if cls._instance is None or not cls._instance._thr.is_alive():
                cls._instance = cls()
            return cls._instance

    def __init__(self) -> None:
        self._sel = selectors.DefaultSelector()
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._sel.register(self._wake_r, selectors.EVENT_READ, None)
        self._ops: deque = deque()  # ("reg", sock, cb) | ("unreg", sock, event)
        self._oplock = threading.Lock()
        self._thr = threading.Thread(target=self._loop, daemon=True,
                                     name="udp-selector")
        self._thr.start()

    def _wake(self) -> None:
        try:
            self._wake_w.send(b"x")
        except OSError:
            pass

    def register(self, sock: socket.socket, cb: Callable) -> None:
        sock.setblocking(False)
        with self._oplock:
            self._ops.append(("reg", sock, cb))
        self._wake()

    def unregister_and_close(self, sock: socket.socket,
                             timeout: float = 1.0) -> None:
        """Unregister + close ON the loop thread (closing a registered fd
        out from under epoll is a race); returns when done or on timeout."""
        done = threading.Event()
        with self._oplock:
            self._ops.append(("unreg", sock, done))
        self._wake()
        if threading.current_thread() is self._thr:
            return  # cb-initiated teardown: the op drains this iteration
        done.wait(timeout)

    def _apply_ops(self) -> None:
        while True:
            with self._oplock:
                if not self._ops:
                    return
                op, sock, arg = self._ops.popleft()
            if op == "reg":
                try:
                    self._sel.register(sock, selectors.EVENT_READ, arg)
                except (KeyError, ValueError, OSError):
                    pass
            else:
                try:
                    self._sel.unregister(sock)
                except (KeyError, ValueError, OSError):
                    pass
                try:
                    sock.close()
                except OSError:
                    pass
                arg.set()

    def _loop(self) -> None:
        while True:
            events = self._sel.select(timeout=0.25)
            self._apply_ops()
            now = time.monotonic()
            for key, _mask in events:
                if key.data is None:  # wake pipe
                    try:
                        while self._wake_r.recv(4096):
                            pass
                    except (BlockingIOError, OSError):
                        pass
                    continue
                sock, cb = key.fileobj, key.data
                # drain everything queued on this socket in one pass
                while True:
                    try:
                        data, addr = sock.recvfrom(4096)
                    except (BlockingIOError, InterruptedError):
                        break
                    except OSError:
                        break
                    try:
                        cb(data, addr, now)
                    except Exception:  # a bad stream must not kill the loop
                        import logging

                        logging.getLogger("media.udp").exception(
                            "udp data_cb failed; socket continues")


class UdpServer:
    """Bound UDP socket with shared-epoll receive and direct dispatch."""

    def __init__(self, laddr: Tuple[str, int],
                 data_cb: Callable[[bytes, Tuple[str, int], float], None]):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind(laddr)
        self.laddr = self.sock.getsockname()
        self.data_cb = data_cb
        self._thr: Optional[threading.Thread] = None
        self._run = True
        if os.environ.get("INFERNOS_UDP_THREADS") == "1":
            self._thr = threading.Thread(target=self._thread_loop, daemon=True,
                                         name=f"udp:{self.laddr[1]}")
            self._thr.start()
        else:
            _SelectorLoop.get().register(self.sock, self._dispatch)

    def _dispatch(self, data: bytes, addr, now: float) -> None:
        if self._run:
            self.data_cb(data, addr, now)

    # -- legacy thread-per-socket receive (INFERNOS_UDP_THREADS=1) ----------
    def _thread_loop(self) -> None:
        self.sock.settimeout(0.25)
        while self._run:
            try:
                data, addr = self.sock.recvfrom(4096)
            except socket.timeout:
                continue
            except OSError:
                break
            self.data_cb(data, addr, time.monotonic())

    def send_to(self, data: bytes, addr: Tuple[str, int]) -> None:
        try:
            self.sock.sendto(data, addr)
        except OSError:
            pass

    def shutdown(self) -> None:
        if not self._run:
            return
        self._run = False
        if self._thr is not None:
            try:
                self.sock.close()
            except OSError:
                pass
            self._thr.join(timeout=1.0)
        else:
            _SelectorLoop.get().unregister_and_close(self.sock)


class RTPPortAllocator:
    """Even-port allocator in [min_port, max_port] (RTP convention)."""

    def __init__(self, min_port: int = 18000, max_port: int = 22000):
        assert min_port % 2 == 0
        self.min_port, self.max_port = min_port, max_port
        self._lock = threading.Lock()
        self._used: set = set()

    def alloc(self) -> int:
        with self._lock:
            ports = list(range(self.min_port, self.max_port, 2))
            random.shuffle(ports)
            for p in ports:
                if p not in self._used:
                    self._used.add(p)
                    return p
        raise RuntimeError("RTP port range exhausted")

    def release(self, port: int) -> None:
        with self._lock:
            self._used.discard(port)

    def bind_server(self, ip: str, data_cb) -> "UdpServer":
        """Allocate a port and bind, retrying on collision with the OS."""
        for _ in range(64):
            port = self.alloc()
            try:
                return UdpServer((ip, port), data_cb)
            except OSError:
                self.release(port)
        raise RuntimeError("could not bind any RTP port")
