"""Generic dynamic-batching worker.

Capability parity with the reference's ``InfernBatchedWorker``
(``Cluster/InfernBatchedWorker.py:14-45``): a queue-draining worker thread
that blocks for one item then greedily drains up to ``max_batch_size`` --
dynamic batching with zero added latency at low load.  ``None`` is the
poison pill; ``proc_start_cb`` fires per item when its batch starts.
"""

from __future__ import annotations

import queue
from typing import Any, Callable, List, Optional

from ..utils.logging import get_logger
from ..utils.threads import WrkThread


log = get_logger("serving.batcher")


class BatchedWorker(WrkThread):
    max_batch_size: int = 8
    #: optional micro-batching window: after the first item arrives, keep
    #: collecting for up to this long before processing.  The reference's
    #: greedy drain has zero added latency but degenerates to batch=1 when
    #: arrivals are staggered, and the VAD worker then runs one forward per
    #: window.  A few ms of window re-batches them at a latency cost that
    #: is negligible against the 96 ms VAD tick.
    batch_wait_s: float = 0.0

    def __init__(self, name: str = "batched", max_batch_size: Optional[int] = None,
                 batch_wait_s: Optional[float] = None):
        super().__init__(name=name)
        if max_batch_size is not None:
            self.max_batch_size = max_batch_size
        if batch_wait_s is not None:
            self.batch_wait_s = batch_wait_s
        self._q: "queue.Queue[Any]" = queue.Queue()
        self.proc_start_cb: Optional[Callable[[Any], None]] = None

    # -- producer side -----------------------------------------------------
    def infer(self, item: Any) -> None:
        self._q.put(item)

    # -- worker side -------------------------------------------------------
    def _next_batch(self) -> Optional[List[Any]]:
        import time

        item = self._q.get()
        if item is None:
            return None
        batch = [item]
        deadline = (time.monotonic() + self.batch_wait_s
                    if self.batch_wait_s > 0.0 else None)
        while len(batch) < self.max_batch_size:
            try:
                if deadline is None:
                    item = self._q.get_nowait()
                else:
                    left = deadline - time.monotonic()
                    item = (self._q.get_nowait() if left <= 0.0
                            else self._q.get(timeout=left))
            except queue.Empty:
                break
            if item is None:
                self._q.put(None)  # re-arm the poison pill for run()
                break
            batch.append(item)
        return batch

    def run(self) -> None:
        while self.should_run():
            batch = self._next_batch()
            if batch is None:
                break
            if self.proc_start_cb is not None:
                for wi in batch:
                    self.proc_start_cb(wi)
            try:
                self.process_batch(batch)
            except Exception:
                log.exception("%s process_batch failed; dropping batch of %d",
                              self.name, len(batch))

    def process_batch(self, batch: List[Any]) -> None:  # override
        raise NotImplementedError

    def on_stop(self) -> None:
        self._q.put(None)
