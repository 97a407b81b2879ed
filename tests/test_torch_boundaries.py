"""Boundaries of the PyTorch port: what it imports and where it runs.

- ``infernos_tpu_torch`` and every submodule import neither ``jax`` nor
  anything of ``infernos_tpu`` (checked in a fresh interpreter, and in the
  source text);
- ``default_device()`` raises when there is no CUDA device;
- on a CUDA tensor the kernel wrappers launch their kernel or raise: the
  dispatch has no route from a CUDA tensor to the plain version and no
  ``try`` that could fall back (read from the code, since there is no card
  here), and the kernel side refuses tensors it cannot take.
"""

import ast
import inspect
import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import infernos_tpu_torch
from infernos_tpu_torch.ops import attention as attn
from infernos_tpu_torch.ops import tts_step as ts
from infernos_tpu_torch.utils import platform

PKG = Path(infernos_tpu_torch.__file__).parent
ROOT = PKG.parent


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages([str(PKG)],
                                                         "infernos_tpu_torch."))


def test_every_submodule_imports_without_jax_or_reference():
    code = (
        "import importlib, json, sys\n"
        f"for m in {_modules()!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'infernos_tpu' or m.startswith('infernos_tpu.'))\n"
        "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120).stdout
    assert json.loads(out.strip().splitlines()[-1]) == []
    assert len(_modules()) >= 20


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")), ids=lambda p: p.name)
def test_no_source_imports_jax_or_reference(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for n in names:
            root = n.split(".")[0]
            assert root not in ("jax", "jaxlib", "infernos_tpu"), f"{path}: {n}"


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        platform.default_device()
    assert platform.default_device("cpu") == torch.device("cpu")


def _cuda_branch_calls(fn):
    """Names called in the ``... == "cuda"`` branch of ``fn`` and whether
    the function holds any ``try``."""
    tree = ast.parse(inspect.getsource(fn))
    has_try = any(isinstance(n, ast.Try) for n in ast.walk(tree))
    calls = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.If, ast.IfExp)) and "'cuda'" in ast.dump(node.test):
            for sub in ast.walk(ast.Module(body=node.body if isinstance(node, ast.If)
                                           else [ast.Expr(node.body)],
                                           type_ignores=[])):
                if isinstance(sub, (ast.Call, ast.Name)):
                    name = sub.func if isinstance(sub, ast.Call) else sub
                    if isinstance(name, ast.Name):
                        calls.add(name.id)
    return calls, has_try


@pytest.mark.parametrize("fn,kernel,plain", [
    (attn.fused_attention, "_kernel_attention", "_plain_attention"),
    (ts.fused_decode_step, "_kernel_decode_step", "_plain_decode_step"),
])
def test_cuda_dispatch_never_routes_to_plain(fn, kernel, plain):
    calls, has_try = _cuda_branch_calls(fn)
    assert kernel in calls and plain not in calls
    assert not has_try
    for f in (attn._kernel_attention, ts._kernel_decode_step):
        assert not any(isinstance(n, ast.Try)
                       for n in ast.walk(ast.parse(inspect.getsource(f))))


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernel side never computes on a CPU tensor (it raises before
    building or launching anything)."""
    q = torch.zeros((2, 16, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        attn._kernel_attention(q, q, q, torch.zeros((2, 16)))
    before = attn.fused_attention.launches
    attn.fused_attention(torch.zeros((1, 16, 128)), torch.zeros((1, 16, 128)),
                         torch.zeros((1, 16, 128)), n_heads=2)
    assert attn.fused_attention.launches == before  # plain path: no launch
