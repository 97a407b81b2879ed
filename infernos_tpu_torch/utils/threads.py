"""Worker-thread lifecycle with an Init/Run/Stop state machine.

Capability parity with the reference's ``InfernWrkThread``
(``Core/InfernWrkThread.py:32-69``): a Thread subclass whose run loop polls
``should_run()`` and whose ``stop()`` transitions state and joins.
"""

from __future__ import annotations

import threading
from enum import Enum


class WrkState(Enum):
    INIT = 0
    RUNNING = 1
    STOPPING = 2
    STOPPED = 3


class WrkThread(threading.Thread):
    """Base class for long-lived worker threads with safe stop semantics."""

    def __init__(self, name: str = "wrk"):
        super().__init__(name=name, daemon=True)
        self._state = WrkState.INIT
        self._state_lock = threading.Lock()

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:  # type: ignore[override]
        with self._state_lock:
            assert self._state == WrkState.INIT, self._state
            self._state = WrkState.RUNNING
        super().start()

    def should_run(self) -> bool:
        with self._state_lock:
            return self._state == WrkState.RUNNING

    def stop(self, join: bool = True) -> None:
        with self._state_lock:
            if self._state in (WrkState.STOPPED, WrkState.INIT):
                self._state = WrkState.STOPPED
                return
            self._state = WrkState.STOPPING
        self.on_stop()
        if join and self.is_alive():
            self.join()
        with self._state_lock:
            self._state = WrkState.STOPPED

    def on_stop(self) -> None:
        """Hook: wake the run loop (e.g. push a poison pill)."""
