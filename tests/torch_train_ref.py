"""Reference training steps for the port's trainer tests.

The reference trainers define their loss and optax chain as closures inside
``main()``; each test writes its trainer's loss again (citing the lines)
and runs it here through ``jax.value_and_grad`` and the same optax chain,
from the JAX init.  The port's trainer runs its own step from the same
init (``from_jax_params``) on the same numpy batches, and the two are held
equal: the loss and every parameter leaf at fp32, 1e-4 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from infernos_tpu_torch.models.convert import from_jax_params
from infernos_tpu_torch.tools import optim

REL = 1e-4


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port_params(jparams):
    """The JAX init as the port's trainable fp32 tree on the CPU."""
    return optim.trainable(from_jax_params(to_numpy(jparams), "cpu"))


def jax_steps(loss_fn, jparams, opt, batches, has_aux=False):
    """``len(batches)`` reference updates: ``loss_fn(params, *batch)``."""
    state = opt.init(jparams)

    @jax.jit
    def step(p, s, *batch):
        if has_aux:
            (loss, _), g = jax.value_and_grad(loss_fn, has_aux=True)(p, *batch)
        else:
            loss, g = jax.value_and_grad(loss_fn)(p, *batch)
        u, s = opt.update(g, s, p)
        return jax.tree_util.tree_map(lambda a, b: a + b, p, u), s, loss

    losses = []
    for batch in batches:
        jparams, state, loss = step(jparams, state, *[jnp.asarray(x) for x in batch])
        losses.append(float(loss))
    return losses, jparams


def assert_losses_close(got, want, rel=REL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rel)


def flat_ref(tree):
    """{leaf name: fp64 array} of a JAX (or numpy) tree."""
    return {jax.tree_util.keystr(k): np.asarray(v, np.float64)
            for k, v in jax.tree_util.tree_flatten_with_path(to_numpy(tree))[0]}


def flat_port(tree):
    """{leaf name: fp64 array} of a port tree, named as :func:`flat_ref`
    names the reference's."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (jax.tree_util.DictKey(k),))
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, path + (jax.tree_util.SequenceKey(i),))
        else:
            v = t.detach().double().numpy() if isinstance(t, torch.Tensor) else t
            out[jax.tree_util.keystr(path)] = np.asarray(v, np.float64)

    walk(tree, ())
    return out


def port_grads(loss, params):
    """The gradient of ``loss`` as a tree shaped like ``params``."""
    grads = iter(torch.autograd.grad(loss, optim.leaves(params), allow_unused=True))

    def grad_of(t):
        g = next(grads)
        return torch.zeros_like(t) if g is None else g

    return optim.map_tree(grad_of, params)


# A gradient element at most this share of the tree's largest |g| (8 ulps of
# fp32) is round-off: an attention key bias, whose exact gradient is zero.
ROUNDOFF = 8 * float(np.finfo(np.float32).eps)


def roundoff(grad_tree):
    """{leaf name: mask} of the elements whose gradient is at round-off,
    for the leaves that have any."""
    flat = flat_ref(grad_tree)
    top = max(float(np.abs(g).max()) for g in flat.values())
    masks = {k: np.abs(g) <= ROUNDOFF * top for k, g in flat.items()}
    return {k: m for k, m in masks.items() if m.any()}


def assert_tree_close(port_tree, jax_tree, rel=REL, excused=None, atol=None):
    """Every leaf within ``rel`` of the reference's, in relative L2 (and the
    whole tree too).

    ``excused`` maps a leaf's name to a mask of elements held instead to
    ``atol`` each; the rest of that leaf is still held to ``rel``.  A test
    derives the masks from the reference, never from the distance: the
    elements whose first-step gradient is at round-off (:func:`roundoff`),
    where Adam steps by the learning rate either way in both packages.
    Returns the names of the leaves that needed their mask."""
    excused = excused or {}
    flat_j, flat_p = flat_ref(jax_tree), flat_port(port_tree)
    assert set(flat_p) == set(flat_j), set(flat_p) ^ set(flat_j)
    used, num, den = [], 0.0, 0.0
    for name, want in flat_j.items():
        got = flat_p[name]
        assert got.shape == want.shape, name
        d = float(np.linalg.norm(got - want))
        n = float(np.linalg.norm(want))
        num, den = num + d * d, den + n * n
        if d <= rel * n:
            continue
        m = excused.get(name)
        assert m is not None, f"{name}: relative L2 {d / max(n, 1e-30)}"
        rest = float(np.linalg.norm((got - want)[~m]))
        assert rest <= rel * n, f"{name}: relative L2 {rest / max(n, 1e-30)} outside its mask"
        worst = float(np.abs(got - want)[m].max())
        assert worst <= atol, f"{name}: an excused element differs by {worst} > {atol}"
        used.append(name)
    assert num ** 0.5 <= rel * den ** 0.5, f"tree relative L2 {(num / den) ** 0.5}"
    return used
