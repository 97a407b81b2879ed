"""In-process sampling profiler for the host path.

The serving host's interpreter is one core's worth of work for every actor,
engine driver and pacer thread.  This sampler captures
``sys._current_frames()`` on a timer thread and aggregates per-thread
Python stacks, splitting samples into ON-CPU-ish vs WAITING by
classifying the leaf frame (known blocking calls: ``wait``, ``get``,
``recvfrom``, ``select``, ``sleep``...).  That is enough to rank where
the host's time goes under a multi-call ramp.

Usage (env-gated so benches can enable it without code changes):

    INFERNOS_PYSAMPLER=prof.json INFERNOS_PYSAMPLER_HZ=200 python -m ...

or programmatically::

    from infernos_tpu_torch.utils.pysampler import Sampler
    s = Sampler(); s.start(); ...; s.stop(); s.dump("prof.json")

The report maps ``"file:func"`` leaf frames and 4-deep stacks to sample
counts.  It is for ranking hotspots, not for absolute timing.

Port of ``infernos_tpu/utils/pysampler.py``, kept equal to it on purpose,
flaw included: :func:`_line_is_wait` counts any leaf whose current source
line calls ``.get(`` or ``.join(`` as waiting, so a ``dict.get`` or a
``str.join`` running on the CPU is filed under WAITING.  Changing that in
the port alone would make its profiles disagree with the reference's on
the same frames; read every waiting share as an upper bound and every
on-CPU share as a lower bound.
"""

from __future__ import annotations

import json
import os
import sys
import threading
from collections import Counter
from typing import Optional

# leaf functions that mean "this thread is parked, not working"
_WAIT_LEAVES = {
    "wait", "get", "acquire", "recvfrom", "recv", "select", "poll",
    "epoll_wait", "sleep", "accept", "read", "settimeout", "join",
    "_recv_internal", "getaddrinfo", "run_forever", "_run_once",
    # Python wrappers whose blocking happens in a C call (the C frame is
    # invisible, so the wrapper itself is the leaf)
    "_wait_for_tstate_lock", "wait_for", "_worker", "select_loop",
}


def _frame_key(fr) -> str:
    co = fr.f_code
    fn = os.path.basename(co.co_filename)
    return f"{fn}:{co.co_name}"


# source-line patterns that mean "this frame is blocked in an invisible C
# call on this line" (time.sleep, sock.recvfrom, selector.select, lock
# acquire...): a Python leaf whose NAME is not a wait wrapper can still be
# parked on such a line, e.g. a ticker loop's ``time.sleep(1.0)``
_WAIT_LINE = None


def _line_is_wait(fr) -> bool:
    global _WAIT_LINE
    if _WAIT_LINE is None:
        import re

        _WAIT_LINE = re.compile(
            r"\.(sleep|recvfrom|recv|select|poll|accept|wait|join|acquire|"
            r"get|result)\(|\btime\.sleep\(|\bsleep\(")
    import linecache

    line = linecache.getline(fr.f_code.co_filename, fr.f_lineno)
    return bool(_WAIT_LINE.search(line))


class Sampler:
    def __init__(self, hz: float = 200.0, max_depth: int = 4):
        self.interval = 1.0 / hz
        self.max_depth = max_depth
        self.leaf_on = Counter()
        self.leaf_wait = Counter()
        self.stack_on = Counter()
        self.thread_on = Counter()
        self.n_samples = 0
        self._stop = threading.Event()
        self._thr: Optional[threading.Thread] = None

    def _tick(self) -> None:
        names = {t.ident: t.name for t in threading.enumerate()}
        me = threading.get_ident()
        for tid, top in sys._current_frames().items():
            if tid == me:
                continue
            leaf = _frame_key(top)
            waiting = (top.f_code.co_name in _WAIT_LEAVES
                       or _line_is_wait(top))
            if waiting:
                self.leaf_wait[leaf] += 1
                continue
            self.leaf_on[leaf] += 1
            self.thread_on[names.get(tid, str(tid))] += 1
            stack, fr, d = [], top, 0
            while fr is not None and d < self.max_depth:
                stack.append(_frame_key(fr))
                fr = fr.f_back
                d += 1
            self.stack_on[" < ".join(stack)] += 1

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            self.n_samples += 1
            try:
                self._tick()
            except Exception:
                pass

    def reset(self) -> None:
        """Zero the counters (e.g. right before a measured window, so the
        boot's warm-ups do not drown the serving-path ranking)."""
        self.leaf_on.clear()
        self.leaf_wait.clear()
        self.stack_on.clear()
        self.thread_on.clear()
        self.n_samples = 0

    def start(self) -> None:
        self._thr = threading.Thread(target=self._run, daemon=True,
                                     name="pysampler")
        self._thr.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thr is not None:
            self._thr.join(timeout=2.0)

    def report(self, top: int = 40) -> dict:
        return {
            "n_samples": self.n_samples,
            "interval_s": self.interval,
            "on_cpu_leaves": self.leaf_on.most_common(top),
            "waiting_leaves": self.leaf_wait.most_common(top),
            "on_cpu_stacks": self.stack_on.most_common(top),
            "on_cpu_threads": self.thread_on.most_common(top),
        }

    def dump(self, path: str, top: int = 40) -> None:
        with open(path, "w") as f:
            json.dump(self.report(top), f, indent=1)


_auto: Optional[Sampler] = None


def maybe_start_from_env() -> Optional[Sampler]:
    """Start a process-wide sampler if INFERNOS_PYSAMPLER is set; the
    report is dumped there at interpreter exit (atexit)."""
    global _auto
    path = os.environ.get("INFERNOS_PYSAMPLER")
    if not path or _auto is not None:
        return _auto
    import atexit

    _auto = Sampler(hz=float(os.environ.get("INFERNOS_PYSAMPLER_HZ", "200")))
    _auto.start()

    def _dump():
        _auto.stop()
        try:
            _auto.dump(path)
        except OSError:
            pass

    atexit.register(_dump)
    return _auto
