"""Lightweight actor runtime: mailbox-serialized objects on worker threads.

Capability parity: the reference distributes per-model workers and the
SIP/RTP engines as **Ray actors** with gRPC RPC and logical-resource
placement (``Infernos.py:67-77``, SURVEY.md section 2.9).  On one card the
heavy compute already lives in a few slot-batched engines sharing one
device (slots, not processes), so process-per-actor buys nothing; what the
actor model still provides -- serialized state mutation, fire-and-forget
calls, location transparency for the app layer -- this runtime keeps:

- each actor owns a mailbox thread (or a small pool when
  ``max_concurrency > 1``, like the reference SIP actor's loop+control
  slots, ``Cluster/InfernSIPActor.py:16-27``);
- ``handle.call`` is fire-and-forget, ``handle.ask`` returns a Future,
  ``handle.ask_sync`` blocks (the ``.remote()`` / ``ray.get`` analogues);
- a multi-host DCN plane can later swap ActorHandle's transport without
  touching callers.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import Future
from typing import Dict, Optional, Type

from ..utils.logging import get_logger

log = get_logger("cluster.actors")


class Actor:
    """Base class; subclasses define plain methods, called via the handle."""

    def on_start(self) -> None:
        """Runs on the actor thread before the mailbox opens."""

    def on_stop(self) -> None:
        """Runs on the actor thread after the mailbox closes."""


class ActorHandle:
    def __init__(self, actor: Actor, name: str, max_concurrency: int = 1):
        self._actor = actor
        self.name = name
        self._q: "queue.Queue" = queue.Queue()
        self._threads = [
            threading.Thread(target=self._loop, args=(i,), daemon=True,
                             name=f"actor:{name}:{i}")
            for i in range(max_concurrency)
        ]
        self._started = threading.Event()
        self._stopping = False
        self._exit_lock = threading.Lock()
        self._exited = 0
        for t in self._threads:
            t.start()

    # -- mailbox ----------------------------------------------------------------
    def _loop(self, idx: int) -> None:
        # exactly thread 0 runs on_start; the rest wait for it so no message
        # is processed before initialization completes
        if idx == 0:
            try:
                self._actor.on_start()
            except Exception:
                log.exception("actor %s on_start failed", self.name)
            self._started.set()
        else:
            self._started.wait()
        while True:
            # the dispatch frame itself is supervised: a bug outside the
            # per-message try (or an exception raised by a broken __getattr__)
            # logs and keeps the mailbox alive instead of silently killing
            # the actor thread and stranding every future caller
            try:
                item = self._q.get()
                if item is None:
                    break
                fut, method, args, kw = item
                try:
                    res = getattr(self._actor, method)(*args, **kw)
                    if fut is not None:
                        fut.set_result(res)
                except Exception as e:
                    if fut is not None:
                        fut.set_exception(e)
                    else:
                        log.exception("actor %s.%s failed", self.name, method)
            except Exception:
                log.exception("actor %s mailbox dispatch error; continuing",
                              self.name)
        # the LAST exiting thread runs on_stop (exactly once)
        with self._exit_lock:
            self._exited += 1
            last = self._exited == len(self._threads)
        if last:
            try:
                self._actor.on_stop()
            except Exception:
                log.exception("actor %s on_stop failed", self.name)

    # -- calling conventions -------------------------------------------------------
    def call(self, method: str, *args, **kw) -> None:
        """Fire-and-forget (the hot-path convention: reference fires
        ``.remote()`` without ray.get on the media path)."""
        self._q.put((None, method, args, kw))

    def ask(self, method: str, *args, **kw) -> Future:
        fut: Future = Future()
        self._q.put((fut, method, args, kw))
        return fut

    def ask_sync(self, method: str, *args, timeout: Optional[float] = 30.0, **kw):
        return self.ask(method, *args, **kw).result(timeout)

    def stop(self) -> None:
        if self._stopping:
            return
        self._stopping = True
        for _ in self._threads:
            self._q.put(None)
        for t in self._threads:
            if t is not threading.current_thread():
                t.join(timeout=5.0)


_registry: Dict[str, ActorHandle] = {}
_registry_lock = threading.Lock()


def spawn(cls: Type[Actor], *args, name: Optional[str] = None,
          max_concurrency: int = 1, **kw) -> ActorHandle:
    actor = cls(*args, **kw)
    name = name or f"{cls.__name__}-{id(actor):x}"
    h = ActorHandle(actor, name, max_concurrency=max_concurrency)
    with _registry_lock:
        _registry[name] = h
    return h


def lookup(name: str) -> Optional[ActorHandle]:
    with _registry_lock:
        return _registry.get(name)


def stop_all() -> None:
    with _registry_lock:
        handles = list(_registry.values())
        _registry.clear()
    for h in handles:
        h.stop()
