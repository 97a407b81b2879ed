"""Parameter trees between the JAX package and the port.

Both packages use the same key paths and the same leaf layouts (linear
weights ``[in, out]``, conv weights ``[K, C_in, C_out]``), so a tree of numpy
arrays taken from the JAX package's parameters maps leaf for leaf onto the
port's tensors.  The tests use this to feed both packages one set of weights.
"""

from __future__ import annotations

from typing import Any, Optional

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
