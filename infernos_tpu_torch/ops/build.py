"""Build the CUDA kernels under ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``build/lib<name>.so`` with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``.
All sources compile in parallel, one ``nvcc`` each.  A library is rebuilt
when its source is newer.  Nothing here runs at import time; a failed build
or load raises -- there is no fallback.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Optional, Sequence

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")
SOURCES = ("attention", "tts_step")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    out = _lib_path(name)
    return not os.path.exists(out) or os.path.getmtime(out) < os.path.getmtime(src)


def nvcc_command(src: str, out: str, extra: Sequence[str] = ()) -> list:
    """The one compile line of every kernel source."""
    return [_nvcc(), *extra, "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", out,
            src]


def build(names: Sequence[str] = SOURCES, verbose: bool = False) -> float:
    """Compile the stale sources in parallel; returns the seconds spent.

    ``verbose`` passes ``-Xptxas -v`` and prints the compiler's report
    (registers, shared memory, spills per kernel).
    """
    t0 = time.monotonic()
    todo = [n for n in names if verbose or _stale(n)]
    if not todo:
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for n in todo:
        tmp = _lib_path(n) + f".tmp{os.getpid()}"
        cmd = nvcc_command(os.path.join(CSRC_DIR, f"{n}.cu"), tmp,
                           ["-Xptxas", "-v"] if verbose else [])
        procs.append((n, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for n, tmp, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu (rc {p.returncode}):\n{out}")
            continue
        if verbose and out:
            print(out)
        os.replace(tmp, _lib_path(n))
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.monotonic() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib: Optional[ctypes.CDLL] = _libs.get(name)
        if lib is None:
            if _stale(name):
                build([name])
            lib = ctypes.CDLL(_lib_path(name))
            _libs[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {rc}")
