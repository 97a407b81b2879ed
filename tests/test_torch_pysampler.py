"""The port's in-process sampling profiler (``utils/pysampler.py``).

- ``Sampler`` start, stop, reset and dump, on a thread that spins and one
  that sleeps;
- ``maybe_start_from_env`` with ``INFERNOS_PYSAMPLER`` set and unset, and
  the dump it leaves at exit;
- ``_line_is_wait`` and the leaf-name set equal to the reference's on the
  same frames and lines, ``.get(`` and ``.join(`` included (the reference's
  flaw, kept for parity: a dict or string call counts as waiting).
"""

import json
import threading
import time
import types
from pathlib import Path

import pytest

from infernos_tpu.utils import pysampler as ref
from infernos_tpu_torch.utils import pysampler as ps

ROOT = Path(__file__).resolve().parents[1]


def _spin(stop):
    x = 0
    while not stop.is_set():
        x += 1


def _nap(stop):
    while not stop.is_set():
        time.sleep(0.005)


def test_sampler_start_stop_reset_dump(tmp_path):
    stop = threading.Event()
    thrs = [threading.Thread(target=f, args=(stop,), name=n, daemon=True)
            for f, n in ((_spin, "spinner"), (_nap, "napper"))]
    for t in thrs:
        t.start()
    s = ps.Sampler(hz=500)
    s.start()
    time.sleep(0.5)
    s.stop()
    stop.set()
    for t in thrs:
        t.join()
    n = s.n_samples
    assert n > 0
    time.sleep(0.05)
    assert s.n_samples == n, "the sampler thread kept running after stop()"
    assert not s._thr.is_alive()
    leaves_on = dict(s.leaf_on)
    assert leaves_on.get("test_torch_pysampler.py:_spin", 0) > 0
    assert dict(s.leaf_wait).get("test_torch_pysampler.py:_nap", 0) > 0
    assert dict(s.thread_on).get("spinner", 0) > 0
    assert any(k.startswith("test_torch_pysampler.py:_spin < ") for k in s.stack_on)
    path = tmp_path / "prof.json"
    s.dump(str(path), top=5)
    rep = json.loads(path.read_text())
    assert set(rep) == {"n_samples", "interval_s", "on_cpu_leaves", "waiting_leaves",
                        "on_cpu_stacks", "on_cpu_threads"}
    assert rep["n_samples"] == n and rep["interval_s"] == pytest.approx(1 / 500)
    assert len(rep["on_cpu_leaves"]) <= 5
    s.reset()
    assert s.n_samples == 0 and not s.leaf_on and not s.leaf_wait
    assert not s.stack_on and not s.thread_on


@pytest.fixture
def no_auto(monkeypatch):
    """A fresh process-wide sampler slot; the exit hook is captured, not
    registered with the interpreter."""
    hooks = []
    monkeypatch.setattr(ps, "_auto", None)
    monkeypatch.setattr("atexit.register", hooks.append)
    yield hooks
    if ps._auto is not None:
        ps._auto.stop()


def test_maybe_start_from_env_unset_starts_nothing(monkeypatch, no_auto):
    monkeypatch.delenv("INFERNOS_PYSAMPLER", raising=False)
    assert ps.maybe_start_from_env() is None
    assert ps._auto is None and no_auto == []


def test_maybe_start_from_env_set_starts_once_and_dumps_at_exit(monkeypatch, no_auto,
                                                                tmp_path):
    path = tmp_path / "auto.json"
    monkeypatch.setenv("INFERNOS_PYSAMPLER", str(path))
    monkeypatch.setenv("INFERNOS_PYSAMPLER_HZ", "400")
    s = ps.maybe_start_from_env()
    assert s is ps._auto and s.interval == pytest.approx(1 / 400)
    assert ps.maybe_start_from_env() is s  # one sampler per process
    assert len(no_auto) == 1
    time.sleep(0.1)
    no_auto[0]()  # what the interpreter runs at exit
    rep = json.loads(path.read_text())
    assert rep["n_samples"] > 0
    assert not s._thr.is_alive()


def _frame(path: Path, lineno: int, name: str = "f"):
    code = types.SimpleNamespace(co_filename=str(path), co_name=name)
    return types.SimpleNamespace(f_code=code, f_lineno=lineno)


LINES = ["x = d.get(k)", "', '.join(parts)", "t.join(timeout=1)", "time.sleep(0.1)",
         "sleep(1)", "sock.recvfrom(2048)", "q.get()", "fut.result()",
         "lock.acquire()", "sel.select(0.1)", "x = y + 1", "total = sum(xs)",
         "self.cv.wait_for(pred)", "return a.getter()", "conn.accept()",
         "p.poll()", "asleep(3)", "s.recv(10)", "evt.wait(0.5)", ""]


def test_line_is_wait_equals_the_reference(tmp_path):
    src = tmp_path / "lines.py"
    src.write_text("\n".join(LINES) + "\n")
    files = [src, ROOT / "infernos_tpu_torch" / "bench" / "ltbench.py",
             ROOT / "infernos_tpu_torch" / "serving" / "stt_engine.py"]
    waits = 0
    for path in files:
        n = len(path.read_text().splitlines())
        for i in range(1, n + 1):
            fr = _frame(path, i)
            got = ps._line_is_wait(fr)
            assert got == ref._line_is_wait(fr), (path.name, i)
            waits += got
    assert waits > 0
    # the reference's classification, flaw included
    assert ps._line_is_wait(_frame(src, 1)) and ps._line_is_wait(_frame(src, 2))
    assert not ps._line_is_wait(_frame(src, 11))
    assert ps._WAIT_LEAVES == ref._WAIT_LEAVES


def test_frame_keys_equal_the_reference():
    import sys

    fr = sys._getframe()
    assert ps._frame_key(fr) == ref._frame_key(fr) == \
        "test_torch_pysampler.py:test_frame_keys_equal_the_reference"
