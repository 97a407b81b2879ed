"""Cross-process actor transport: the multi-host plane.

The reference scales across hosts with Ray's gRPC actor RPC (SURVEY.md
section 2.9 "Distributed communication backend"); this module provides the
same calling conventions over a length-prefixed pickle protocol on TCP:

- :class:`ActorServer` exposes this process's actor registry
  (``cluster.actors.lookup``) to peers;
- :class:`RemoteActorHandle` mirrors :class:`ActorHandle`'s surface
  (``call`` fire-and-forget / ``ask`` Future / ``ask_sync`` / ``stop``);
- **callbacks cross the wire**: any callable inside the message (e.g.
  ``STTRequest.text_cb``, ``AudioInput.vad_chunk_in``) is replaced during
  pickling with a stub that, when invoked remotely, sends an ``op=cb``
  frame back over the same connection and runs the original callable in
  its home process -- the pattern Ray gets from serialized partials
  (``SIP/RemoteSession.py:8-17``);
- :class:`ActorHandle` arguments are proxied the same way, so a remote
  actor can call back into its peer's actors transparently.

Reliability (the surface Ray's gRPC transport gives the reference for
free):

- **bounded send queue + backpressure**: frames go through a writer thread
  with a bounded queue; producers block briefly under pressure, then the
  link is declared dead (a peer that can't drain is indistinguishable from
  a dead one on the media path).
- **heartbeat / dead-peer detection**: periodic pings; a link with no
  inbound traffic for ``dead_after`` seconds closes, failing its futures.
- **fail-fast**: sends and callback stubs on a closed link raise
  ``ConnectionError`` immediately -- callers EOS their sessions instead of
  hanging.
- **reconnect with re-registration**: :class:`PeerLink` supervises a
  connection, redials with backoff, and fires ``on_down``/``on_up`` hooks
  so owners can EOS stranded sessions and re-register state.

Trust model: the plane is an intra-cluster transport, like Ray's; it must
only be bound to cluster-internal interfaces.  Pickle is used deliberately
for parity with Ray's cloudpickle semantics.

Port of ``infernos_tpu/cluster/remote.py``: the names, the wire protocol
(ops ``call``, ``ask``, ``result``, ``cb``, ``spawn``, ``stop_actor``,
``ping``, ``pong``; a 4-byte big-endian length, then the pickle) and the
defaults are the reference's, and plain-data frames are the same bytes.
What differs, and why:

- The wire carries numpy arrays and plain data, never a ``torch.Tensor``
  or an ``nn.Module``: the pickler refuses both with ``TypeError``.  A
  module is callable, so the reference's rule would turn it into a
  callback stub whose calls return nothing; a CUDA tensor pickled by value
  is rebuilt on the receiver's card, and fails on a peer without one.
  Model actors take seeds, configs and device names (``device="cpu"`` as a
  string) and build their weights where they run.
- A peer serves its model actors on its card: an actor started there
  without ``device`` raises without a card (``utils.platform
  .default_device``), and the asker's ``ask_sync("start")`` raises that
  error, relayed as every actor error is (``RuntimeError(repr(e))``).
- A peer is a fresh interpreter (``subprocess``), never a ``fork``: a CUDA
  context does not survive one.
- ``ActorServer.close`` closes every connection: each one's close removes
  it from ``conns``, and the reference's loop over that same list skipped
  every second one.

Two behaviours of the reference are kept as they are: a ``spawn`` whose
import or ``__init__`` raises is only logged by the dispatcher, so
``spawn_remote`` waits out its timeout; and errors arrive as
``RuntimeError(repr(e))``, not as their own type.
"""

from __future__ import annotations

import io
import pickle
import socket
import struct
import threading
from concurrent.futures import Future
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..utils.logging import get_logger
from .actors import ActorHandle, lookup, spawn

log = get_logger("cluster.remote")

_MAX_CALLBACKS = 65536


class _Pickler(pickle.Pickler):
    def __init__(self, buf, conn: "Connection"):
        super().__init__(buf, protocol=pickle.HIGHEST_PROTOCOL)
        self.conn = conn

    def persistent_id(self, obj):
        if isinstance(obj, (torch.Tensor, torch.nn.Module)):
            raise TypeError(
                f"remote link {self.conn.name}: a {type(obj).__name__} does "
                "not cross the wire; send numpy arrays and plain data "
                "(tensor.cpu().numpy()), and let the peer build its models")
        if isinstance(obj, ActorHandle):
            return ("actor", obj.name)
        if isinstance(obj, RemoteActorHandle):
            # a proxied handle going back to (or through) a peer: address it
            # by name; the receiving side resolves locally first
            return ("actor", obj.name)
        if callable(obj) and not isinstance(obj, type):
            import functools
            import types

            # Pickle's own machinery serializes reconstructor FUNCTIONS
            # (e.g. numpy._reconstruct) -- those must pass through by
            # reference, NOT become callback stubs.  Proxy only stateful /
            # unpicklable callables, where by-value copies would also be
            # semantically wrong for callbacks (mutations lost):
            if isinstance(obj, (types.MethodType, functools.partial)):
                return ("cb", self.conn._register_callback(obj))
            if isinstance(obj, types.FunctionType):
                if obj.__name__ == "<lambda>" or "<locals>" in obj.__qualname__:
                    return ("cb", self.conn._register_callback(obj))
                return None  # importable module-level function
            if isinstance(obj, (types.BuiltinFunctionType,
                                types.BuiltinMethodType)):
                return None
            # instances with __call__ are callbacks with state: proxy
            return ("cb", self.conn._register_callback(obj))
        return None


class _Unpickler(pickle.Unpickler):
    def __init__(self, buf, conn: "Connection"):
        super().__init__(buf)
        self.conn = conn

    def persistent_load(self, pid):
        kind, ref = pid
        if kind == "actor":
            local = lookup(ref)
            if local is not None:
                return local
            return RemoteActorHandle(self.conn, ref)
        if kind == "cb":
            conn, cb_id = self.conn, ref
            return lambda *a, **kw: conn._send({"op": "cb", "cb": cb_id,
                                                "args": a, "kw": kw})
        raise pickle.UnpicklingError(f"unknown pid {pid!r}")


class Connection:
    """One bidirectional peer link: framing, callback tables, dispatch."""

    def __init__(self, sock: socket.socket, name: str = "peer",
                 on_close: Optional[Callable[["Connection"], None]] = None,
                 send_queue: int = 4096, send_timeout: float = 5.0,
                 heartbeat_s: float = 5.0, dead_after_s: float = 20.0):
        import collections
        import os
        import time

        self.sock = sock
        self.name = name
        self._on_close = on_close
        self._cbs: Dict[int, Callable] = {}
        self._cb_next = 1
        self._cb_lock = threading.Lock()
        self._futures: Dict[int, Future] = {}
        self._fut_next = 1
        self._fut_lock = threading.Lock()
        self.closed = threading.Event()
        self._close_once = threading.Lock()
        self._close_fired = False
        # bounded writer queue (backpressure): producers never touch the
        # socket; a queue that stays full past send_timeout kills the link
        self._sq: "collections.deque" = collections.deque()
        self._sq_max = send_queue
        self._sq_timeout = send_timeout
        self._sq_cv = threading.Condition()
        self.last_rx = time.monotonic()
        self._hb_interval = heartbeat_s
        self._dead_after = dead_after_s
        # Mixed-version rolling upgrades: a peer running a pre-heartbeat
        # protocol revision neither answers pings nor generates idle
        # traffic, so rx-silence would tear every idle link down each
        # dead_after_s.  INFERNOS_HB_LEGACY_GRACE=1 exempts peers that
        # have never ponged from the rx-silence deadline (TCP write
        # failure still kills the link); default OFF because it also
        # exempts genuinely hung peers -- upgrade both hosts together,
        # or set the grace only for the rollout window.
        self._legacy_grace = os.environ.get(
            "INFERNOS_HB_LEGACY_GRACE", "") not in ("", "0")
        self._pong_seen = False
        # dispatch runs OFF the reader thread: a slow handler (model spawn,
        # heavy callback) must not stall frame reads or ping replies, or the
        # heartbeat would declare a busy peer dead
        self._dq: "collections.deque" = collections.deque()
        self._dq_cv = threading.Condition()
        self._reader = threading.Thread(target=self._read_loop, daemon=True,
                                        name=f"remote:{name}")
        self._writer = threading.Thread(target=self._write_loop, daemon=True,
                                        name=f"remote-w:{name}")
        self._dispatcher = threading.Thread(target=self._dispatch_loop,
                                            daemon=True,
                                            name=f"remote-d:{name}")
        self._reader.start()
        self._writer.start()
        self._dispatcher.start()
        if heartbeat_s > 0:
            self._hb = threading.Thread(target=self._heartbeat_loop,
                                        daemon=True, name=f"remote-hb:{name}")
            self._hb.start()

    # -- callback table ---------------------------------------------------------
    def _register_callback(self, fn: Callable) -> int:
        with self._cb_lock:
            cb_id = self._cb_next
            self._cb_next += 1
            self._cbs[cb_id] = fn
            if len(self._cbs) > _MAX_CALLBACKS:
                # evict oldest (bounded table; a dropped stale callback logs
                # on invocation instead of leaking forever)
                oldest = min(self._cbs)
                del self._cbs[oldest]
        return cb_id

    # -- framing -----------------------------------------------------------------
    def _send(self, msg: Dict[str, Any]) -> None:
        """Enqueue a frame for the writer thread.

        Raises ``ConnectionError`` when the link is closed (fail fast, never
        hang a session on a dead peer) or when backpressure persists past
        ``send_timeout`` (the link is then closed: an undrainable peer is a
        dead peer for real-time traffic), and ``TypeError`` for a tensor or
        a module in the message."""
        if self.closed.is_set():
            raise ConnectionError(f"link {self.name} is down")
        buf = io.BytesIO()
        _Pickler(buf, self).dump(msg)
        data = struct.pack("!I", buf.tell()) + buf.getvalue()
        stuck = False
        with self._sq_cv:
            if len(self._sq) >= self._sq_max:
                self._sq_cv.wait_for(
                    lambda: len(self._sq) < self._sq_max
                    or self.closed.is_set(), timeout=self._sq_timeout)
                stuck = (len(self._sq) >= self._sq_max
                         and not self.closed.is_set())
            if not stuck:
                if self.closed.is_set():
                    raise ConnectionError(f"link {self.name} is down")
                self._sq.append(data)
                self._sq_cv.notify_all()
        if stuck:
            log.error("link %s: send queue stuck at %d frames; closing",
                      self.name, self._sq_max)
            self.close()
            raise ConnectionError(f"link {self.name} backpressure overflow")

    def _send_quiet(self, msg: Dict[str, Any]) -> None:
        """Best-effort send for internal replies (no raise on closed)."""
        try:
            self._send(msg)
        except (ConnectionError, OSError):
            pass

    def _write_loop(self) -> None:
        while True:
            with self._sq_cv:
                self._sq_cv.wait_for(
                    lambda: self._sq or self.closed.is_set())
                if not self._sq and self.closed.is_set():
                    return
                data = self._sq.popleft()
                self._sq_cv.notify_all()
            try:
                self.sock.sendall(data)
            except OSError:
                self.close()
                return

    def _heartbeat_loop(self) -> None:
        import time

        while not self.closed.wait(self._hb_interval):
            if time.monotonic() - self.last_rx > self._dead_after:
                if self._legacy_grace and not self._pong_seen:
                    # rollout window: a never-ponged peer may be a healthy
                    # legacy revision; rely on TCP write failure instead
                    log.info("link %s: idle %.1fs but peer has never "
                             "ponged; legacy grace keeps the link up",
                             self.name, self._dead_after)
                else:
                    log.warning("link %s: no traffic for %.1fs; "
                                "declaring dead", self.name,
                                self._dead_after)
                    self.close()
                    return
            self._send_quiet({"op": "ping"})

    def _recv_exact(self, n: int) -> Optional[bytes]:
        out = b""
        while len(out) < n:
            try:
                chunk = self.sock.recv(n - len(out))
            except OSError:
                return None
            if not chunk:
                return None
            out += chunk
        return out

    def _read_loop(self) -> None:
        import time

        while not self.closed.is_set():
            hdr = self._recv_exact(4)
            if hdr is None:
                break
            size = struct.unpack("!I", hdr)[0]
            data = self._recv_exact(size)
            if data is None:
                break
            self.last_rx = time.monotonic()
            try:
                msg = _Unpickler(io.BytesIO(data), self).load()
            except Exception:
                log.exception("remote frame decode failed on %s", self.name)
                continue
            op = msg.get("op")
            if op == "ping":  # liveness handled inline, never queued
                self._send_quiet({"op": "pong"})
            elif op == "pong":
                self._pong_seen = True
            elif op == "result":
                self._dispatch(msg)  # resolve futures promptly
            else:
                with self._dq_cv:
                    self._dq.append(msg)
                    self._dq_cv.notify()
        self._finalize_close()

    def _dispatch_loop(self) -> None:
        while True:
            with self._dq_cv:
                self._dq_cv.wait_for(
                    lambda: self._dq or self.closed.is_set())
                if not self._dq:
                    if self.closed.is_set():
                        return
                    continue
                msg = self._dq.popleft()
            try:
                self._dispatch(msg)
            except Exception:
                log.exception("remote dispatch failed on %s", self.name)

    def _finalize_close(self) -> None:
        self.closed.set()
        with self._sq_cv:
            self._sq_cv.notify_all()  # unblock writer + backpressured senders
        with self._dq_cv:
            self._dq_cv.notify_all()  # let the dispatcher drain and exit
        with self._fut_lock:
            futs = list(self._futures.values())
            self._futures.clear()
        for f in futs:
            if not f.done():
                f.set_exception(ConnectionError("peer closed"))
        fire = False
        with self._close_once:
            if not self._close_fired:
                self._close_fired = True
                fire = True
        if fire and self._on_close is not None:
            try:
                self._on_close(self)
            except Exception:
                log.exception("on_close hook failed for %s", self.name)

    # -- dispatch ----------------------------------------------------------------
    def _dispatch(self, msg: Dict[str, Any]) -> None:
        op = msg["op"]
        if op == "ping":
            self._send_quiet({"op": "pong"})
            return
        if op == "pong":
            self._pong_seen = True
            return  # last_rx already refreshed by the read loop
        if op == "call":
            h = lookup(msg["actor"])
            if h is None:
                log.warning("call to unknown actor %r", msg["actor"])
                return
            h.call(msg["method"], *msg["args"], **msg["kw"])
        elif op == "ask":
            h = lookup(msg["actor"])
            rid = msg["id"]
            if h is None:
                self._send_quiet({"op": "result", "id": rid, "ok": False,
                                  "error": f"unknown actor {msg['actor']!r}"})
                return
            fut = h.ask(msg["method"], *msg["args"], **msg["kw"])

            def done(f, rid=rid):
                try:
                    self._send_quiet({"op": "result", "id": rid, "ok": True,
                                      "value": f.result()})
                except Exception as e:
                    self._send_quiet({"op": "result", "id": rid, "ok": False,
                                      "error": repr(e)})

            fut.add_done_callback(done)
        elif op == "result":
            with self._fut_lock:
                fut = self._futures.pop(msg["id"], None)
            if fut is not None:
                if msg["ok"]:
                    fut.set_result(msg["value"])
                else:
                    fut.set_exception(RuntimeError(msg["error"]))
        elif op == "cb":
            fn = self._cbs.get(msg["cb"])
            if fn is None:
                log.warning("remote callback %d expired", msg["cb"])
                return
            try:
                fn(*msg["args"], **msg["kw"])
            except Exception:
                log.exception("remote callback failed")
        elif op == "spawn":
            import importlib

            mod, cls = msg["cls"].rsplit(":", 1)
            h = spawn(getattr(importlib.import_module(mod), cls),
                      *msg["args"], name=msg["name"], **msg["kw"])
            self._send_quiet({"op": "result", "id": msg["id"], "ok": True,
                              "value": h.name})
        elif op == "stop_actor":
            h = lookup(msg["actor"])
            if h is not None:
                h.stop()

    # -- client surface ------------------------------------------------------------
    def new_future(self) -> Tuple[int, Future]:
        with self._fut_lock:
            rid = self._fut_next
            self._fut_next += 1
            fut: Future = Future()
            self._futures[rid] = fut
        return rid, fut

    def spawn_remote(self, cls_path: str, *args, name: str,
                     timeout: float = 300.0, **kw) -> "RemoteActorHandle":
        rid, fut = self.new_future()
        self._send({"op": "spawn", "id": rid, "cls": cls_path, "name": name,
                    "args": args, "kw": kw})
        return RemoteActorHandle(self, fut.result(timeout))

    def close(self) -> None:
        self._finalize_close()
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()


class RemoteActorHandle:
    """ActorHandle surface over a :class:`Connection`."""

    def __init__(self, conn: Connection, name: str):
        self._conn = conn
        self.name = name

    def call(self, method: str, *args, **kw) -> None:
        self._conn._send({"op": "call", "actor": self.name, "method": method,
                          "args": args, "kw": kw})

    def ask(self, method: str, *args, **kw) -> Future:
        rid, fut = self._conn.new_future()
        self._conn._send({"op": "ask", "id": rid, "actor": self.name,
                          "method": method, "args": args, "kw": kw})
        return fut

    def ask_sync(self, method: str, *args, timeout: Optional[float] = 30.0,
                 **kw):
        return self.ask(method, *args, **kw).result(timeout)

    def stop(self) -> None:
        self._conn._send({"op": "stop_actor", "actor": self.name})


class ActorServer:
    """Expose this process's actors to peers (one Connection per peer)."""

    def __init__(self, bind: Tuple[str, int] = ("127.0.0.1", 0)):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind(bind)
        self.sock.listen(16)
        self.laddr = self.sock.getsockname()
        self.conns: list = []
        self._run = True
        self._thr = threading.Thread(target=self._accept_loop, daemon=True,
                                     name=f"actor-server:{self.laddr[1]}")
        self._thr.start()

    def _accept_loop(self) -> None:
        while self._run:
            try:
                sock, addr = self.sock.accept()
            except OSError:
                break
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self.conns.append(Connection(
                sock, name=f"{addr[0]}:{addr[1]}", on_close=self._prune))

    def _prune(self, conn: Connection) -> None:
        try:
            self.conns.remove(conn)
        except ValueError:
            pass

    def close(self) -> None:
        self._run = False
        try:
            self.sock.close()
        except OSError:
            pass
        for c in list(self.conns):
            c.close()


def connect(addr: Tuple[str, int], timeout: float = 10.0,
            **conn_kw) -> Connection:
    sock = socket.create_connection(addr, timeout=timeout)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    sock.settimeout(None)
    return Connection(sock, name=f"{addr[0]}:{addr[1]}", **conn_kw)


class PeerLink:
    """Supervised connection: redial with backoff, re-registration hooks.

    ``on_down(link)`` fires the moment the current connection dies -- the
    owner EOSes sessions that depended on it (fail fast, never hang).
    ``on_up(link)`` fires after every successful (re)connect -- the owner
    re-registers sessions/handles (callback tables are per-connection, so
    state carried by stubs must be re-established).  ``link.handle(name)``
    returns an actor handle that always routes through the CURRENT
    connection and raises ``ConnectionError`` while the link is down.
    """

    def __init__(self, addr: Tuple[str, int],
                 on_up: Optional[Callable[["PeerLink"], None]] = None,
                 on_down: Optional[Callable[["PeerLink"], None]] = None,
                 retry_min_s: float = 0.2, retry_max_s: float = 5.0,
                 max_retries: Optional[int] = None, **conn_kw):
        self.addr = addr
        self.on_up = on_up
        self.on_down = on_down
        self.retry_min_s = retry_min_s
        self.retry_max_s = retry_max_s
        self.max_retries = max_retries
        self._conn_kw = conn_kw
        self._conn: Optional[Connection] = None
        self._lock = threading.Lock()
        self._closed = False
        self._dial()  # initial connect failures raise to the creator
        if self.on_up is not None:
            self.on_up(self)

    # -- connection management ------------------------------------------------
    def _dial(self) -> None:
        conn = connect(self.addr, on_close=self._conn_closed,
                       **self._conn_kw)
        with self._lock:
            self._conn = conn

    def _conn_closed(self, conn: Connection) -> None:
        with self._lock:
            if self._conn is not conn:
                return  # stale
            self._conn = None
            if self._closed:
                return
        log.warning("peer link %s down; redialing", self.addr)
        if self.on_down is not None:
            try:
                self.on_down(self)
            except Exception:
                log.exception("on_down hook failed")
        threading.Thread(target=self._redial_loop, daemon=True,
                         name=f"peerlink:{self.addr[0]}").start()

    def _redial_loop(self) -> None:
        import time

        delay = self.retry_min_s
        attempt = 0
        while not self._closed:
            attempt += 1
            if self.max_retries is not None and attempt > self.max_retries:
                log.error("peer link %s: gave up after %d attempts",
                          self.addr, self.max_retries)
                return
            try:
                self._dial()
            except OSError:
                time.sleep(delay)
                delay = min(delay * 2, self.retry_max_s)
                continue
            log.info("peer link %s re-established (attempt %d)",
                     self.addr, attempt)
            if self.on_up is not None:
                try:
                    self.on_up(self)
                except Exception:
                    log.exception("on_up hook failed")
            return

    # -- surface ---------------------------------------------------------------
    @property
    def up(self) -> bool:
        c = self._conn
        return c is not None and not c.closed.is_set()

    def conn(self) -> Connection:
        c = self._conn
        if c is None or c.closed.is_set():
            raise ConnectionError(f"peer link {self.addr} is down")
        return c

    def handle(self, name: str) -> "LinkActorHandle":
        return LinkActorHandle(self, name)

    def spawn_remote(self, cls_path: str, *args, name: str,
                     timeout: float = 300.0, **kw) -> "LinkActorHandle":
        self.conn().spawn_remote(cls_path, *args, name=name,
                                 timeout=timeout, **kw)
        return self.handle(name)

    def close(self) -> None:
        self._closed = True
        c = self._conn
        if c is not None:
            c.close()


class LinkActorHandle:
    """Actor handle routed through a :class:`PeerLink`'s live connection."""

    def __init__(self, link: PeerLink, name: str):
        self._link = link
        self.name = name

    def call(self, method: str, *args, **kw) -> None:
        self._link.conn()._send({"op": "call", "actor": self.name,
                                 "method": method, "args": args, "kw": kw})

    def ask(self, method: str, *args, **kw) -> Future:
        conn = self._link.conn()
        rid, fut = conn.new_future()
        conn._send({"op": "ask", "id": rid, "actor": self.name,
                    "method": method, "args": args, "kw": kw})
        return fut

    def ask_sync(self, method: str, *args, timeout: Optional[float] = 30.0,
                 **kw):
        return self.ask(method, *args, **kw).result(timeout)

    def stop(self) -> None:
        self._link.conn()._send({"op": "stop_actor", "actor": self.name})
