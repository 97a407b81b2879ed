"""Parameter trees between the JAX package, HF checkpoints and the port.

Both packages use the same key paths and the same leaf layouts (linear
weights ``[in, out]``, conv weights ``[K, C_in, C_out]``), so a tree of numpy
arrays taken from the JAX package's parameters maps leaf for leaf onto the
port's tensors.  The tests use this to feed both packages one set of weights.
:class:`HFStateDict` reads an HF model's ``state_dict()`` for the models'
``port_from_hf``.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional

import numpy as np
import torch


def from_numpy(tree: Any, device: torch.device | str,
               dtype: Optional[torch.dtype] = None) -> Any:
    """Nested dict/list/tuple of array-likes -> same nesting of tensors.

    Floating leaves are cast to ``dtype`` (when given); integer and bool
    leaves keep their type.
    """
    if isinstance(tree, dict):
        return {k: from_numpy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [from_numpy(v, device, dtype) for v in tree]
        return out if isinstance(tree, list) else tuple(out)
    arr = np.asarray(tree)
    t = torch.from_numpy(np.array(arr, copy=True)).to(device)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t


def from_jax_params(tree_of_numpy: Any, device: torch.device | str,
                    dtype: Optional[torch.dtype] = None) -> Any:
    """The JAX package's parameters (leaves already turned into numpy
    arrays, e.g. with ``jax.tree_util.tree_map(np.asarray, params)``) ->
    the port's parameter tree on ``device``."""
    return from_numpy(tree_of_numpy, device, dtype)


def cast_floating(tree: Any, dtype: torch.dtype) -> Any:
    """Cast every floating tensor of a parameter tree to ``dtype``, except
    the ``scale`` of a quantized linear node (``{"w_q", "scale"[, "b"]}``,
    ``models/quant.py``): int8 scales stay fp32, as the reference keeps
    them in its packed weights, so a quantized tree may be cast after it
    was quantized without narrowing them."""
    if isinstance(tree, dict):
        quantized = "w_q" in tree
        return {k: v if quantized and k == "scale" else cast_floating(v, dtype)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [cast_floating(v, dtype) for v in tree]
        return out if isinstance(tree, list) else tuple(out)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


class HFStateDict:
    """An HF model's ``state_dict()``, read by key name for ``port_from_hf``.

    Every key must be read once or match a pattern of ``skip`` (a regex ->
    the reason it holds no weight the port needs); :meth:`finish` raises
    ``ValueError`` naming any other key, so a checkpoint whose layout has
    drifted loses no tensor silently.  Leaves come out fp32 on the state
    dict's device, in the port's layouts, never through the host.
    """

    def __init__(self, model, skip: Dict[str, str]):
        self.sd = dict(model.state_dict())
        self.skip = skip
        self.read: set = set()

    def has(self, key: str) -> bool:
        return key in self.sd

    def t(self, key: str) -> torch.Tensor:
        """The tensor at ``key`` as fp32, marked read."""
        if key not in self.sd:
            raise ValueError(f"port_from_hf: state dict has no {key!r}")
        self.read.add(key)
        return self.sd[key].detach().float()

    def tied(self, key: str, to: str) -> None:
        """``key`` must equal ``to`` (a tied weight the port stores once; on
        the meta device only the shapes can be compared)."""
        if key in self.sd:
            a, b = self.t(key), self.t(to)
            if a.shape != b.shape or (a.device.type != "meta" and not torch.equal(a, b)):
                raise ValueError(f"port_from_hf: {key!r} is not tied to {to!r}")

    def lin(self, prefix: str) -> Dict[str, torch.Tensor]:
        """``Linear`` ``[out, in]`` -> ``{"w": [in, out](, "b")}``."""
        p = {"w": self.t(f"{prefix}.weight").T.contiguous()}
        if self.has(f"{prefix}.bias"):
            p["b"] = self.t(f"{prefix}.bias")
        return p

    def ln(self, prefix: str) -> Dict[str, torch.Tensor]:
        return {"g": self.t(f"{prefix}.weight"), "b": self.t(f"{prefix}.bias")}

    def conv(self, prefix: str) -> Dict[str, torch.Tensor]:
        """``Conv1d`` ``[C_out, C_in, K]`` -> ``[K, C_in, C_out]``, and
        ``ConvTranspose1d`` ``[C_in, C_out, K]`` -> ``[K, C_out, C_in]``
        (the same axis reversal)."""
        p = {"w": self.t(f"{prefix}.weight").permute(2, 1, 0).contiguous()}
        if self.has(f"{prefix}.bias"):
            p["b"] = self.t(f"{prefix}.bias")
        return p

    def finish(self) -> None:
        left = [k for k in self.sd if k not in self.read
                and not any(re.fullmatch(p, k) for p in self.skip)]
        if left:
            raise ValueError(f"port_from_hf: {len(left)} state-dict keys were "
                             f"not read: {left[:8]}")
