"""The optimiser, schedules and losses the port's trainers share.

Copies of what the reference's trainers take from ``optax`` (which the port
does not import): :class:`AdamW` is ``optax.adamw`` (``scale_by_adam``, then
``add_decayed_weights`` on every leaf, biases and LayerNorms too, then the
learning rate), and the schedules follow optax's step semantics: the first
update reads the schedule at count 0, so a warmup from 0.0 leaves the
parameters of the first step unchanged, as in the reference.

Precision: fp32 on every device, as the reference trains.  The forward
reads the fp32 parameters themselves, so on the card the encoder's fp32
q/k/v projections reach the attention kernel's fp32 mode; the card's
matmuls and convolutions run in full fp32, not TF32
(``utils/platform.default_device``).
"""

from __future__ import annotations

import math
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

Schedule = Callable[[int], float]


# -- parameter trees ------------------------------------------------------------

def leaves(tree: Any) -> List[torch.Tensor]:
    """The floating tensors of a nested dict/list tree, in key order."""
    if isinstance(tree, dict):
        return [t for k in tree for t in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves(v)]
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return [tree]
    return []


def map_tree(fn, tree: Any) -> Any:
    """``fn`` on every floating tensor of a tree; other leaves kept."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [map_tree(fn, v) for v in tree]
        return out if isinstance(tree, list) else tuple(out)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return fn(tree)
    return tree


def trainable(tree: Any) -> Any:
    """An fp32 copy of a tree whose floating leaves require grad."""
    return map_tree(lambda t: t.detach().float().clone().requires_grad_(), tree)


# -- schedules ------------------------------------------------------------------

def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Schedule:
    """``optax.linear_schedule``."""
    if transition_steps <= 0:
        return lambda count: init_value

    def schedule(count):
        frac = 1 - min(max(count, 0), transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0, exponent: float = 1.0) -> Schedule:
    """``optax.cosine_decay_schedule``."""
    if not decay_steps > 0:
        raise ValueError("cosine_decay_schedule requires positive decay_steps, "
                         f"got {decay_steps}")

    def schedule(count):
        count = min(count, decay_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1 - alpha) * cosine ** exponent + alpha)

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0,
                                 exponent: float = 1.0) -> Schedule:
    """``optax.warmup_cosine_decay_schedule``: linear from ``init_value`` to
    ``peak_value`` over ``warmup_steps``, then cosine to ``end_value`` at
    ``decay_steps`` (which counts the warmup)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warm = linear_schedule(init_value, peak_value, warmup_steps)
    decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps,
                                  alpha, exponent)
    return lambda count: warm(count) if count < warmup_steps else decay(count - warmup_steps)


# -- AdamW ----------------------------------------------------------------------

class AdamW:
    """``optax.adamw(learning_rate, b1, b2, eps, eps_root=0, weight_decay)``
    over a list of fp32 leaves, updated in place.

    ``count`` is the number of updates made; the learning rate of an
    update is ``lr(count)`` read before the count moves, as optax's
    ``scale_by_learning_rate`` reads its own count."""

    def __init__(self, params: List[torch.Tensor],
                 learning_rate: Union[float, Schedule], *, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 1e-4):
        self.params = list(params)
        self.lr = learning_rate if callable(learning_rate) else (
            lambda count, v=learning_rate: v)
        self.b1, self.b2, self.eps, self.wd = b1, b2, eps, weight_decay
        self.mu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: List[Optional[torch.Tensor]]) -> None:
        lr = float(self.lr(self.count))
        self.count += 1
        c1 = 1 - self.b1 ** self.count
        c2 = 1 - self.b2 ** self.count
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            g = torch.zeros_like(mu) if g is None else g.float()
            mu.mul_(self.b1).add_(g, alpha=1 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            u = (mu / c1) / (torch.sqrt(nu / c2) + self.eps) + self.wd * p
            p.add_(u, alpha=-lr)



def train_step(loss_fn: Callable[..., Tuple[torch.Tensor, Any]], params: Any,
               opt: AdamW, *args) -> Tuple[torch.Tensor, Any]:
    """One update: ``loss_fn(params, *args) -> (loss, aux)``, gradients of
    the fp32 parameters, then AdamW.  Returns the loss (fp32, detached) and
    ``aux``."""
    loss, aux = loss_fn(params, *args)
    grads = torch.autograd.grad(loss, opt.params, allow_unused=True)
    opt.step(grads)
    return loss.detach().float(), aux


def to_device(batch, device) -> tuple:
    """A numpy batch as tensors on ``device``."""
    return tuple(torch.from_numpy(np.asarray(x)).to(device) for x in batch)


def fit(loss_fn, params: Any, opt: AdamW, cfg, batches: Callable[[int], tuple],
        steps: int, *, log_every: int = 100,
        report: Optional[Callable[[int, float, Any], str]] = None,
        on_step: Optional[Callable[[int, float], None]] = None) -> List[float]:
    """``steps`` updates of ``params`` in place: step ``i`` runs
    :func:`train_step` on ``loss_fn(p, cfg, *batches(i))``.  Every
    ``log_every`` steps (and the last) it prints ``report(step, loss,
    aux)`` with the seconds so far; ``on_step(step, loss)`` runs after each.
    Returns the losses."""
    losses: List[float] = []
    t0 = time.time()
    for step in range(steps):
        loss, aux = train_step(loss_fn, params, opt, cfg, *batches(step))
        losses.append(float(loss))
        if log_every and (step % log_every == 0 or step == steps - 1):
            line = (report(step, losses[-1], aux) if report
                    else f"step {step} loss {losses[-1]:.4f}")
            print(f"{line} ({time.time() - t0:.0f}s)", flush=True)
        if on_step is not None:
            on_step(step, losses[-1])
    return losses


# -- losses ---------------------------------------------------------------------

def softmax_cross_entropy_with_integer_labels(logits, labels):
    """``optax.softmax_cross_entropy_with_integer_labels``: per position,
    in fp32."""
    logits = logits.float()
    return torch.logsumexp(logits, -1) - logits.gather(
        -1, labels.long()[..., None])[..., 0]


def sigmoid_binary_cross_entropy(logits, labels):
    """``optax.sigmoid_binary_cross_entropy``, elementwise in fp32."""
    logits = logits.float()
    return -labels * F.logsigmoid(logits) - (1 - labels) * F.logsigmoid(-logits)


# -- outputs --------------------------------------------------------------------

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REFERENCE = os.path.join(os.path.dirname(_PKG), "infernos_tpu")


def default_out(name: str) -> str:
    """``infernos_tpu_torch/build/trained/<name>``: where a trainer writes
    unless told otherwise (git-ignored)."""
    return os.path.join(_PKG, "build", "trained", name)


def check_out(path: str) -> str:
    """The absolute output directory; raises for one inside the JAX
    package (``infernos_tpu/``), whose vendored checkpoints the port never
    writes."""
    path = os.path.realpath(path)
    ref = os.path.realpath(_REFERENCE)
    if path == ref or path.startswith(ref + os.sep):
        raise ValueError(f"trainer output {path} is inside {ref}: the port "
                         "never writes the JAX package's checkpoints")
    return path
