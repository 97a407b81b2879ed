"""Keystr ``.npz`` checkpoints <-> nested dicts/lists of torch tensors.

The vendored checkpoints under ``infernos_tpu/models/data/`` store each leaf
under its JAX ``keystr`` path (``['lstm'][0]['wi']``).  The port reads those
files by path -- a file read, not an import of the reference package -- and
rebuilds the same nesting, so parameter key paths match the JAX pytrees.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from .convert import from_numpy

_DATA_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "infernos_tpu", "models", "data")


def data_path(name: str) -> str:
    """Vendored checkpoint location for ``name`` (e.g. ``tiny_stt``);
    ``INFERNOS_TINY_DATA_<NAME>`` overrides it, as in the reference."""
    override = os.environ.get(f"INFERNOS_TINY_DATA_{name.upper()}")
    if override:
        return override
    return os.path.join(_DATA_DIR, name)


def _keystr_flatten(tree: Any, prefix: str = ""):
    """``(keystr path, leaf)`` pairs of a nested dict/list tree: dict keys
    as ``['name']``, list items as ``[0]`` (JAX's ``keystr``)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _keystr_flatten(v, f"{prefix}['{k}']")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _keystr_flatten(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def save_params(path: str, params: Any) -> None:
    """Write a tree as a keystr ``.npz`` that this module's and the
    reference's ``load_params`` both read (tensors to numpy on the host;
    bf16 widens to fp32, which numpy lacks)."""
    flat = {}
    for key, leaf in _keystr_flatten(params):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu()
            if leaf.dtype == torch.bfloat16:
                leaf = leaf.float()
            leaf = leaf.numpy()
        flat[key] = np.asarray(leaf)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **flat)


def load_numpy_tree(path: str) -> Optional[Dict[str, Any]]:
    """Nested dict/list of numpy arrays, or None when ``path`` is absent."""
    if not os.path.exists(path):
        return None
    raw = np.load(path)
    root: Dict[str, Any] = {}
    for key in raw.files:
        val = raw[key]
        parts = [s.strip("'") for s in
                 key.replace("]", "").split("[") if s.strip("'")]
        node: Any = root
        for i, part in enumerate(parts[:-1]):
            idx: Any = int(part) if part.isdigit() else part
            nxt_is_int = parts[i + 1].isdigit()
            if isinstance(node, list):
                while len(node) <= idx:
                    node.append([] if nxt_is_int else {})
            elif idx not in node:
                node[idx] = [] if nxt_is_int else {}
            node = node[idx]
        last = parts[-1]
        if isinstance(node, list):
            li = int(last)
            while len(node) <= li:
                node.append(None)
            node[li] = val
        else:
            node[int(last) if last.isdigit() else last] = val
    return root


def load_params(path: str, device: torch.device | str,
                dtype: Optional[torch.dtype] = None) -> Optional[Dict[str, Any]]:
    """Load a keystr ``.npz`` into tensors on ``device`` (floating leaves
    cast to ``dtype`` when given); None when the file is absent."""
    tree = load_numpy_tree(path)
    if tree is None:
        return None
    return from_numpy(tree, device, dtype)
