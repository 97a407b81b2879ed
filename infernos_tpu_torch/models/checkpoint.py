"""Parameter checkpoints: save a converted tree once, load it at start.

Port of ``infernos_tpu/models/checkpoint.py``.  A model is ported from its
HF layout once (``models/*.port_from_hf``), saved, and loaded cold when a
server starts, so start-up skips the conversion.

What differs, and why:

- The format is ``params.pt``: ``torch.save`` of a flat dict keyed by the
  ``/``-joined key paths of the reference's npz fallback (``enc_layers/
  attn/q/w``, list items by index).  The reference saves with orbax, which
  the card's machine does not have.
- Dtypes stay as given: a bf16 tree stays bf16, and the int8 codes and fp32
  scales of ``quant.quantize_params`` stay as they are.
- :func:`load` also reads the reference's ``params.npz`` fallback (fp32
  and int8 leaves), as the reference's ``load`` reads both its formats.
- A key missing from the file, or a leaf whose shape differs from
  ``like``'s, raises ``ValueError`` naming the key: nothing is served
  half-loaded.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Iterator, Optional, Tuple

import numpy as np
import torch

PARAMS_PT = "params.pt"
PARAMS_NPZ = "params.npz"


def flatten(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``(key path, leaf)`` of a nested dict/list/tuple tree, the path
    ``/``-joined (dict keys, then list indices)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flatten(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flatten(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _rebuild(like: Any, leaf_for, prefix: str = "") -> Any:
    if isinstance(like, dict):
        return {k: _rebuild(v, leaf_for, f"{prefix}{k}/") for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        out = [_rebuild(v, leaf_for, f"{prefix}{i}/") for i, v in enumerate(like)]
        return out if isinstance(like, list) else tuple(out)
    return leaf_for(prefix[:-1], like)


def save(path: str, params: Any, config: Optional[Any] = None) -> None:
    """Save a parameter tree (and a dataclass config) into directory ``path``."""
    os.makedirs(path, exist_ok=True)
    flat = {}
    for k, v in flatten(params):
        v = v.detach().contiguous()
        # a view saves its whole storage: keep only the leaf's bytes
        flat[k] = v.clone() if v.untyped_storage().nbytes() != v.nbytes else v
    torch.save(flat, os.path.join(path, PARAMS_PT))
    if config is not None:
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(dataclasses.asdict(config), f, indent=2, default=str)


def load(path: str, like: Any, device=None) -> Any:
    """Load a tree saved by :func:`save` (or the reference's ``params.npz``)
    into the structure of ``like``, on ``device`` (default: where the file's
    tensors were saved from)."""
    pt = os.path.join(path, PARAMS_PT)
    if os.path.exists(pt):
        data = torch.load(pt, map_location=device, weights_only=True, mmap=True)
    else:
        npz = np.load(os.path.join(path, PARAMS_NPZ))
        data = {k: torch.from_numpy(np.array(npz[k])) for k in npz.files}
        if device is not None:
            data = {k: v.to(device) for k, v in data.items()}

    def leaf_for(key: str, ref) -> torch.Tensor:
        if key not in data:
            raise ValueError(f"checkpoint {path}: no leaf {key!r}")
        t = data[key]
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"checkpoint {path}: leaf {key!r} has shape "
                             f"{tuple(t.shape)}, want {tuple(ref.shape)}")
        return t

    return _rebuild(like, leaf_for)


def load_config(path: str, cls) -> Any:
    """The dataclass ``cls`` saved beside a checkpoint (lists back to
    tuples, unknown fields dropped)."""
    with open(os.path.join(path, "config.json")) as f:
        d = json.load(f)
    fields = {f.name for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in d.items():
        if k not in fields:
            continue
        if isinstance(v, list):
            v = tuple(tuple(x) if isinstance(x, list) else x for x in v)
        kwargs[k] = v
    return cls(**kwargs)
