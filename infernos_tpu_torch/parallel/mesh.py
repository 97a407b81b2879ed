"""Device mesh and sharding layouts over ``torch.distributed``.

Port of ``infernos_tpu/parallel/mesh.py``.  The JAX mesh is one controller
over N devices, and XLA inserts the collectives.  Here the counterpart is
SPMD: one process per rank (``parallel/ranks.py`` starts them), every rank
running the same host program on its own shard, and the model calling its
collectives itself.  The axes keep their meaning:

- **dp**: the streaming engines' batch slots, a contiguous block per rank
  (each rank runs an engine of its block; no collective in steady state);
- **tp**: tensor parallelism for the LLM (``models/qwen.py``): column
  shards for q/k/v/gate/up, row shards for o/down, one sum over the group
  per attention block and per MLP, the readout sharded over the vocab and
  its logits gathered.

The port's code calls only a sum (:meth:`Mesh.psum`), a broadcast
(:func:`replicate`) and a gather (:meth:`Mesh.gather_last`), so it runs on
any backend.  The backend follows from where the ranks are, chosen once in
:func:`make_mesh`, kept in :attr:`Mesh.backend` and printed: ``nccl`` when
every rank has a card of its own, ``gloo`` when the ranks are on the CPU or
share cards (NCCL refuses two ranks on one device; gloo stages CUDA tensors
through the host).

A spec is a :class:`P`: an axis name or ``None`` per dimension, a tuple, so
``tuple(jax_spec) == tuple(port_spec)`` compares specs across packages.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
from typing import Any, Optional, Sequence, Tuple

import torch

from ..utils.platform import DeviceLike, default_device

#: environment a rank process gets from ``parallel/ranks.py``: its rank, the
#: number of ranks, the rendezvous file and the process group's timeout (s)
RANK_ENV = ("INFERNOS_RANK", "INFERNOS_WORLD", "INFERNOS_RDZV", "INFERNOS_PG_TIMEOUT_S")


class P(tuple):
    """A ``PartitionSpec``: one mesh-axis name (or tuple of names, or
    ``None``) per dimension; missing trailing dimensions replicate."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def backend_for(device_type: str, n_ranks: int) -> str:
    """``nccl`` when each of ``n_ranks`` has a card of its own, else
    ``gloo`` (ranks on the CPU, or ranks sharing a card)."""
    if device_type == "cuda" and n_ranks <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of an N-rank mesh.

    ``groups`` holds one process group per axis (``None``: the default
    group when the mesh has one axis, or no group at all when no process
    group exists).  Without a process group a mesh can still describe one
    rank of a larger layout (``coords`` says which), as the shape tests do
    on ``meta`` tensors; its collectives then act on shapes only, and on a
    tensor with values they raise unless the axis has one rank.
    """

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    coords: Tuple[int, ...]
    device: torch.device
    backend: Optional[str] = None
    groups: Tuple[Any, ...] = ()

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def rank(self) -> int:
        """Row-major rank of ``coords``."""
        r = 0
        for c, n in zip(self.coords, self.shape):
            r = r * n + c
        return r

    def axis_size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    def axis_index(self, axis: str) -> int:
        return self.coords[self.axis_names.index(axis)]

    def _group(self, axis: str):
        i = self.axis_names.index(axis)
        return self.groups[i] if self.groups else None

    def _collective(self, x: torch.Tensor, axis: str) -> bool:
        """Whether ``x`` needs a real collective over ``axis``."""
        if self.axis_size(axis) == 1 and self.backend is None:
            return False
        if x.is_meta:
            return False
        if self.backend is None:
            raise RuntimeError(f"mesh axis {axis!r} of {self.axis_size(axis)} ranks "
                               "has no process group (start the ranks with "
                               "parallel.ranks.run_ranks)")
        return True

    def psum(self, x: torch.Tensor, axis: str = "tp") -> torch.Tensor:
        """Sum of ``x`` over the ranks of ``axis``, every rank getting the
        same values.  Partial sums are reduced in fp32 and cast back."""
        if not self._collective(x, axis):
            return x
        import torch.distributed as dist

        y = x.float() if x.dtype != torch.float32 else x.clone()
        dist.all_reduce(y, group=self._group(axis))
        return y.to(x.dtype)

    def gather_last(self, x: torch.Tensor, full: int, axis: str = "tp") -> torch.Tensor:
        """This rank's block of the last dimension (of a ``full``-wide
        tensor, blocks laid out as :func:`shard` cuts them) -> the whole
        tensor on every rank.  Done as a sum into a zeroed full-width buffer,
        which takes uneven blocks and any backend; adding zeros is exact,
        so the values are the blocks' own."""
        n, i = self.axis_size(axis), self.axis_index(axis)
        if not self._collective(x, axis):  # one rank, or shapes only
            if n == 1:
                return x
            return torch.empty((*x.shape[:-1], full), dtype=x.dtype, device=x.device)
        import torch.distributed as dist

        lo, hi = block(full, n, i)
        out = torch.zeros((*x.shape[:-1], full), dtype=x.dtype, device=x.device)
        out[..., lo:hi] = x
        dist.all_reduce(out, group=self._group(axis))
        return out


def block(n: int, parts: int, i: int) -> Tuple[int, int]:
    """Bounds of part ``i`` of ``n`` cut into ``parts`` contiguous blocks
    of ``ceil(n / parts)`` (the last may be short), as XLA lays out an
    uneven ``NamedSharding``."""
    size = math.ceil(n / parts)
    return min(i * size, n), min((i + 1) * size, n)


def _rank_env():
    vals = [os.environ.get(k) for k in RANK_ENV]
    if any(v is None for v in vals):
        return None
    return int(vals[0]), int(vals[1]), vals[2], float(vals[3])


def make_mesh(n_devices: Optional[int] = None, axes: Sequence[str] = ("dp",),
              shape: Optional[Sequence[int]] = None,
              device: DeviceLike = None) -> Mesh:
    """This rank's :class:`Mesh` over ``n_devices`` ranks.

    In a rank process started by ``parallel/ranks.py`` (or with a process
    group already up) it joins the group: on first use it initialises the
    default group with the backend :func:`backend_for` picks, prints that
    choice, and makes one group per axis.  Outside, ``n_devices`` 1 (or
    None) gives a one-rank mesh with no process group, and more raises.
    ``device`` is the card unless the CPU is asked for; a rank on the card
    binds ``cuda:(rank % device_count)``.
    """
    import torch.distributed as dist

    axes = tuple(axes)
    env = _rank_env()
    if not dist.is_initialized() and env is None:
        if n_devices not in (None, 1):
            raise RuntimeError(
                f"make_mesh({n_devices}): several ranks need rank processes "
                "(parallel.ranks.run_ranks) or a process group")
        dev = default_device(device)
        return Mesh(axes, (1,) * len(axes), (0,) * len(axes), dev)
    if env is not None:
        rank, world, rdzv, timeout_s = env
    else:
        rank, world, rdzv, timeout_s = dist.get_rank(), dist.get_world_size(), None, None
    if n_devices is None:
        n_devices = world
    if n_devices != world:
        raise ValueError(f"make_mesh({n_devices}) in a group of {world} ranks")
    shape = tuple(shape) if shape is not None else (world,) + (1,) * (len(axes) - 1)
    if math.prod(shape) != world or len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} for axes {axes} over {world} ranks")
    dev = default_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        backend = backend_for(dev.type, world)
        dist.init_process_group(
            backend, init_method=f"file://{rdzv}", rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        if rank == 0:
            why = ("a card per rank" if backend == "nccl" else
                   "ranks on the CPU" if dev.type == "cpu" else
                   f"{world} ranks share {torch.cuda.device_count()} card(s): "
                   "NCCL refuses two ranks on one device")
            print(f"make_mesh: {world} ranks on {dev.type}, backend {backend} ({why})",
                  flush=True)
    backend = dist.get_backend()
    coords, r = [], rank
    for n in reversed(shape):
        coords.append(r % n)
        r //= n
    coords = tuple(reversed(coords))
    groups = []
    for i in range(len(axes)):
        if len(axes) == 1:
            groups.append(None)  # the default group
            continue
        mine = None
        # every rank creates every group of the axis, in the same order
        for other in _axis_groups(shape, i):
            g = dist.new_group(other)
            if rank in other:
                mine = g
        groups.append(mine)
    return Mesh(axes, shape, coords, dev, backend, tuple(groups))


def _axis_groups(shape, axis: int):
    """The rank lists that differ only in coordinate ``axis``."""
    import itertools

    rest = [range(n) for j, n in enumerate(shape) if j != axis]
    out = []
    for fixed in itertools.product(*rest):
        ranks = []
        for c in range(shape[axis]):
            coords = list(fixed)
            coords.insert(axis, c)
            r = 0
            for cc, n in zip(coords, shape):
                r = r * n + cc
            ranks.append(r)
        out.append(ranks)
    return out


# -- trees ----------------------------------------------------------------------

def _is_spec(x) -> bool:
    return x is None or isinstance(x, P)


def _rebuild(node, items):
    if isinstance(node, list):
        return list(items)
    return type(node)(*items) if hasattr(node, "_fields") else tuple(items)


def tree_map(fn, tree):
    """Map ``fn`` over the tensors of a dict/list/tuple/dataclass tree;
    other leaves are kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name)) for f in dataclasses.fields(tree)})
    if isinstance(tree, (list, tuple)):
        return _rebuild(tree, [tree_map(fn, v) for v in tree])
    return tree


def map_with_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree of tensors and the matching tree of
    specs (a :class:`P` or ``None`` per leaf, as ``param_shardings``
    builds them); raises ``ValueError`` where the two trees differ."""
    if isinstance(tree, torch.Tensor):
        if not _is_spec(specs):
            raise ValueError(f"spec tree: {specs!r} where a leaf's spec belongs")
        return fn(tree, specs)
    if isinstance(tree, dict):
        if not isinstance(specs, dict) or set(specs) != set(tree):
            raise ValueError(f"spec tree keys {sorted(specs) if isinstance(specs, dict) else specs} "
                             f"!= {sorted(tree)}")
        return {k: map_with_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        if _is_spec(specs) or len(specs) != len(tree):
            raise ValueError(f"spec tree {specs!r} against {len(tree)} items")
        return _rebuild(tree, [map_with_specs(fn, v, s) for v, s in zip(tree, specs)])
    raise ValueError(f"not a tensor tree: {type(tree)}")


def shard_leaf(x: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """This rank's block of ``x`` under ``spec``: each sharded dimension
    cut into contiguous blocks in rank order (``jax.device_put(x,
    NamedSharding(mesh, spec))`` seen from one rank), copied out."""
    if spec is None:
        return x
    out = x
    for d, ax in enumerate(spec):
        if ax is None or d >= x.dim():
            continue
        names = ax if isinstance(ax, tuple) else (ax,)
        parts, idx = 1, 0
        for a in names:
            parts, idx = parts * mesh.axis_size(a), idx * mesh.axis_size(a) + mesh.axis_index(a)
        lo, hi = block(x.shape[d], parts, idx)
        out = out.narrow(d, lo, hi - lo)
    return out.contiguous() if out is not x else x


def shard(tree, specs, mesh: Mesh):
    """This rank's block of every leaf of ``tree`` under the matching spec
    tree (:func:`shard_leaf`)."""
    return map_with_specs(lambda x, s: shard_leaf(x, s, mesh), tree, specs)


def replicate(tree, mesh: Mesh):
    """Every rank gets rank 0's values of every tensor of ``tree``
    (broadcast over the mesh, in place)."""
    if mesh.backend is None:
        return tree
    import torch.distributed as dist

    def bcast(x):
        dist.broadcast(x, src=0)
        return x

    return tree_map(bcast, tree)


def shard_tts_state(state, mesh: Mesh, axis: str = "dp"):
    """This rank's block of a ``TTSState``'s slots over ``axis``.

    Cache tensors are ``[L, B, H, T, Dh]`` (slot axis 1); everything else is
    slot-major ``[B, ...]`` (axis 0).
    """
    return tree_map(lambda x: shard_leaf(x, P(None, axis) if x.dim() >= 5 else P(axis),
                                         mesh), state)
