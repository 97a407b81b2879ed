"""Engine driver: steps a slot-batched engine while work is pending.

The serving engines (TTS/STT/LLM) expose ``step() -> bool`` and are driven
from exactly one thread.  The driver parks when idle and wakes on ``kick()``
(called after submissions), so at zero load the device is untouched and at
any load the engine free-runs -- the analogue of the reference's
queue-blocking batched worker loop (``Cluster/InfernBatchedWorker.py:17-28``)
for slot-based engines.

Supervision (beyond the reference, which strands all sessions when a worker
thread dies, SURVEY section 5.3): if ``step()`` raises, the driver flushes
EOS to every caller via ``engine.abort_all()`` and keeps serving.  A crash
storm (>= ``max_crashes`` inside ``crash_window_s``) stops the driver
instead of burning the device in a hot loop.
"""

from __future__ import annotations

import threading
import time

from ..utils.logging import get_logger
from ..utils.metrics import metrics
from ..utils.threads import WrkThread

log = get_logger("serving.driver")


class EngineDriver(WrkThread):
    def __init__(self, engine, name: str = "engine",
                 max_crashes: int = 3, crash_window_s: float = 30.0):
        super().__init__(name=f"drv:{name}")
        self.engine = engine
        self._wake = threading.Event()
        self.max_crashes = max_crashes
        self.crash_window_s = crash_window_s
        self.crash_times: list = []

    def kick(self) -> None:
        self._wake.set()

    def _handle_crash(self, exc: BaseException) -> bool:
        """Restart path: flush sessions, decide whether to keep serving."""
        now = time.monotonic()
        self.crash_times = [t for t in self.crash_times
                            if now - t < self.crash_window_s] + [now]
        metrics.inc("driver.crashes")
        log.exception("engine %s step crashed (restart %d/%d in %.0fs window)",
                      self.name, len(self.crash_times), self.max_crashes,
                      self.crash_window_s)
        abort = getattr(self.engine, "abort_all", None)
        if abort is not None:
            try:
                abort(reason=f"driver restart after {type(exc).__name__}")
            except Exception:
                log.exception("engine %s abort_all failed", self.name)
        if len(self.crash_times) >= self.max_crashes:
            log.error("engine %s crash storm: stopping driver", self.name)
            return False
        return True

    def run(self) -> None:
        while self.should_run():
            try:
                busy = self.engine.step()
            except Exception as e:
                if not self._handle_crash(e):
                    return
                busy = False
            if not busy:
                self._wake.wait(timeout=0.1)
                self._wake.clear()

    def on_stop(self) -> None:
        self._wake.set()
