"""In-process metrics registry: counters, gauges, and latency histograms.

Capability parity: the reference exports scalars to tensorboardX
(``Apps/LiveTranslator/LTActor.py:82-85``, ``Cluster/InfernBenchActor.py:345-360``)
and prints GPU-occupancy telemetry (``safetorch/InfernTorcher.py:44-53``).
We centralize this into one registry with percentile support so the serving
engines can report p50/p95/p99 without external deps.
"""

from __future__ import annotations

import bisect
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional


class _Hist:
    """Bounded reservoir histogram with sorted insertion for percentiles."""

    __slots__ = ("values", "count", "total", "maxlen", "_lock")

    def __init__(self, maxlen: int = 4096):
        self.values: List[float] = []
        self.count = 0
        self.total = 0.0
        self.maxlen = maxlen
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        with self._lock:
            self.count += 1
            self.total += v
            bisect.insort(self.values, v)
            if len(self.values) > self.maxlen:
                # Drop from the middle-out alternating ends would skew; drop
                # a pseudo-random interior element keyed on count instead.
                del self.values[self.count % (self.maxlen - 2) + 1]

    def percentile(self, p: float) -> float:
        with self._lock:
            if not self.values:
                return 0.0
            idx = min(len(self.values) - 1, int(p / 100.0 * len(self.values)))
            return self.values[idx]

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0


@dataclass
class Metrics:
    """Thread-safe metrics registry."""

    counters: Dict[str, float] = field(default_factory=dict)
    gauges: Dict[str, float] = field(default_factory=dict)
    hists: Dict[str, _Hist] = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def inc(self, name: str, delta: float = 1.0) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0.0) + delta

    def set(self, name: str, value: float) -> None:
        with self._lock:
            self.gauges[name] = value

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            h = self.hists.get(name)
            if h is None:
                h = self.hists[name] = _Hist()
        h.observe(value)

    def timer(self, name: str) -> "_Timer":
        return _Timer(self, name)

    def snapshot(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        with self._lock:
            out.update(self.counters)
            out.update(self.gauges)
            for name, h in self.hists.items():
                out[f"{name}.mean"] = h.mean
                out[f"{name}.p50"] = h.percentile(50)
                out[f"{name}.p95"] = h.percentile(95)
                out[f"{name}.p99"] = h.percentile(99)
                out[f"{name}.count"] = h.count
        return out


class _Timer:
    __slots__ = ("_m", "_name", "_t0")

    def __init__(self, m: Metrics, name: str):
        self._m, self._name = m, name
        self._t0: Optional[float] = None

    def __enter__(self) -> "_Timer":
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc) -> None:
        assert self._t0 is not None
        self._m.observe(self._name, time.monotonic() - self._t0)


#: Process-global registry (the common case; tests construct their own).
metrics = Metrics()
