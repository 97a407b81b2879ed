"""Rank processes: the port's counterpart of JAX's single controller.

:func:`run_ranks` starts N processes (``spawn``: each a fresh interpreter
that imports the function it runs by module path), lets them meet through a
file in a fresh temporary directory (never a fixed TCP port, so several
runs on one host do not collide), runs the same function in each and
returns what each returned, in rank order.  The function builds its mesh
with :func:`parallel.mesh.make_mesh`, which initialises the process group
from what this module hands the rank.

Each rank runs with a process-group timeout (60 s by default), so a
collective that a dead or diverging rank never joins raises instead of
waiting forever; on the CPU it runs torch on one thread (the default pool,
one thread per core in every rank, starves a loaded host); on the card it
binds ``cuda:(rank % device_count)``.  The parent polls the ranks against a
deadline: when one fails, or the deadline passes, it kills the ranks that
are left and raises with every rank's exit code and the tail of its
standard error.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import shutil
import sys
import tempfile
import time
from typing import Any, Callable, List, Sequence

from ..utils.platform import DeviceLike, default_device
from .mesh import RANK_ENV

PG_TIMEOUT_S = 60.0
DEADLINE_S = 600.0
STDERR_TAIL = 2000  # bytes of each failed rank's stderr in the error
_POLL_S = 0.05
_GRACE_S = 2.0  # a failed rank's peers get this long to end on their own


def _rank_main(rank: int, n: int, fn: Callable, args: Sequence[Any], device_type: str,
               rdzv: str, timeout_s: float, out_dir: str) -> None:
    """One rank: stderr to a file, the rank's environment, torch's threads
    or card, then ``fn(*args)``, its result pickled for the parent."""
    err = open(os.path.join(out_dir, f"stderr.{rank}"), "w", buffering=1)
    os.dup2(err.fileno(), 2)
    sys.stderr = err
    os.environ.update(zip(RANK_ENV, (str(rank), str(n), rdzv, str(timeout_s))))
    import torch

    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    else:
        torch.set_num_threads(1)
    result = fn(*args)
    path = os.path.join(out_dir, f"result.{rank}")
    with open(path + ".tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(path + ".tmp", path)
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def _tail(path: str) -> str:
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            f.seek(max(0, f.tell() - STDERR_TAIL))
            return f.read().decode(errors="replace")
    except OSError:
        return ""


def run_ranks(fn: Callable, n: int, args: Sequence[Any] = (), *,
              device: DeviceLike = None, timeout_s: float = PG_TIMEOUT_S,
              deadline_s: float = DEADLINE_S) -> List[Any]:
    """Run ``fn(*args)`` in ``n`` rank processes; returns their results in
    rank order.

    ``fn`` must be importable by module path (a module-level function of a
    module that the ranks may import).  ``device`` is the card unless the
    CPU is asked for: without ``device="cpu"`` and without a card this
    raises before starting anything.  ``timeout_s`` bounds each collective;
    ``deadline_s`` the whole run.
    """
    dev = default_device(device)
    ctx = mp.get_context("spawn")
    out_dir = tempfile.mkdtemp(prefix="infernos-ranks-")
    procs = []
    try:
        for r in range(n):
            p = ctx.Process(target=_rank_main, name=f"rank{r}",
                            args=(r, n, fn, tuple(args), dev.type,
                                  os.path.join(out_dir, "rdzv"), timeout_s, out_dir))
            p.start()
            procs.append(p)
        end = time.monotonic() + deadline_s
        failed_at = None
        while any(p.exitcode is None for p in procs):
            now = time.monotonic()
            if failed_at is None and any(p.exitcode not in (None, 0) for p in procs):
                failed_at = now
            if now > end or (failed_at is not None and now > failed_at + _GRACE_S):
                break
            time.sleep(_POLL_S)
        late = [p for p in procs if p.exitcode is None]
        for p in late:
            p.kill()
        for p in procs:
            p.join(timeout=10.0)
        if late or any(p.exitcode != 0 for p in procs):
            why = (f"deadline of {deadline_s} s passed" if failed_at is None
                   else "a rank failed")
            lines = [f"run_ranks({getattr(fn, '__name__', fn)}, {n}): {why}"]
            for r, p in enumerate(procs):
                code = "killed" if p in late else p.exitcode
                lines.append(f"-- rank {r}: exit {code}\n"
                             f"{_tail(os.path.join(out_dir, f'stderr.{r}'))}")
            raise RuntimeError("\n".join(lines))
        results = []
        for r in range(n):
            with open(os.path.join(out_dir, f"result.{r}"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10.0)
        shutil.rmtree(out_dir, ignore_errors=True)
