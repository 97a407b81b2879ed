"""Per-device memory budget of sharded programs, computed from shapes.

Port of ``infernos_tpu/parallel/budget.py`` with the same arithmetic: a
sharded dimension divides by its mesh-axis size (ceil, as XLA pads uneven
shards), a bare ``None`` spec is a replicated leaf.  It works on trees of
tensors on the ``meta`` device (``init_params(..., device="meta")`` draws
nothing), in place of ``jax.eval_shape``, so a 14B accounting takes
milliseconds and no memory.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Tuple

import torch

from .mesh import map_with_specs, tree_map

#: v5e: 16 GiB HBM per chip (the JAX package's limit, kept for parity; the
#: card's own limit is read on the card, ``torch.cuda.get_device_properties``)
V5E_HBM_BYTES = 16 * 1024**3


def _leaf_bytes_per_chip(shape: Tuple[int, ...], itemsize: int,
                         spec, axis_sizes: Mapping[str, int]) -> int:
    """Bytes one device holds of a leaf laid out under ``spec``.

    Sharded dims divide by the mesh-axis size (ceil: XLA pads uneven
    shards); unsharded/missing dims replicate.
    """
    dims = list(shape)
    if spec is not None:
        for i, ax in enumerate(spec):
            if ax is None or i >= len(dims):
                continue
            axes = ax if isinstance(ax, tuple) else (ax,)
            div = 1
            for a in axes:
                div *= int(axis_sizes[a])
            dims[i] = math.ceil(dims[i] / div)
    if not dims:
        return itemsize
    return math.prod(max(1, d) for d in dims) * itemsize


def per_chip_bytes(shapes: Any, specs: Any,
                   axis_sizes: Mapping[str, int]) -> int:
    """Total per-device bytes of a tree of tensors (``meta`` or not) placed
    under a matching tree of specs; ``ValueError`` where the trees differ."""
    total = [0]

    def add(leaf: torch.Tensor, spec) -> None:
        total[0] += _leaf_bytes_per_chip(tuple(leaf.shape), leaf.element_size(),
                                         spec, axis_sizes)

    map_with_specs(add, shapes, specs)
    return total[0]


def replicated_bytes(shapes: Any) -> int:
    """Per-device bytes of an unsharded (replicated) tree."""
    total = [0]

    def add(x: torch.Tensor) -> None:
        total[0] += x.numel() * x.element_size()

    tree_map(add, shapes)
    return total[0]


def budget_report(parts: Dict[str, int], limit: int = V5E_HBM_BYTES,
                  headroom: float = 0.10) -> Dict[str, Any]:
    """Summarize named per-device byte contributions against a memory limit.

    ``headroom`` reserves a fraction of the memory for scratch and
    fragmentation (temporaries are not visible to shape accounting).
    """
    total = sum(parts.values())
    usable = int(limit * (1.0 - headroom))
    return {
        "parts_gib": {k: round(v / 1024**3, 3) for k, v in parts.items()},
        "total_gib": round(total / 1024**3, 3),
        "usable_gib": round(usable / 1024**3, 3),
        "fits": total <= usable,
    }
