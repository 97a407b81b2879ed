"""The port's VAD and AmendNet trainers against ``tools/train_vad.py`` and
``tools/train_amendnet.py``.

Batches must equal the reference trainers' bit for bit for the same numpy
seed; three steps from the JAX init must match reference steps written from
their ``loss_fn``s (``tools/train_vad.py:81-87`` over ``seq_apply`` at
``:46-55``, ``tools/train_amendnet.py:122-124``) and optax chains
(``train_vad.py:76``, ``train_amendnet.py:117``) at fp32 within 1e-4
relative; the weights load through each model's ``load_pretrained(path)``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from infernos_tpu.models import amendnet as jamd
from infernos_tpu.models import vad as jvad
from infernos_tpu_torch.models import amendnet as amd
from infernos_tpu_torch.models import vad as vad_m
from infernos_tpu_torch.tools import optim
from infernos_tpu_torch.tools import train_amendnet as PA
from infernos_tpu_torch.tools import train_vad as PV
from tools import train_amendnet as JA
from tools import train_vad as JV

from torch_train_ref import (assert_losses_close, assert_tree_close, jax_steps,
                             port_params)


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", [0, 5])
def test_batches_are_the_reference_trainers_bit_for_bit(seed):
    cfg = vad_m.VADConfig()
    for a, b in zip(PV.make_batch(np.random.default_rng(seed), 3, 6, cfg.window),
                    JV.make_batch(np.random.default_rng(seed), 3, 6, cfg.window)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    acfg = amd.AmendNetConfig()
    for a, b in zip(PA.make_batch(np.random.default_rng(seed), 5, acfg),
                    JA.make_batch(np.random.default_rng(seed), 5, jamd.AmendNetConfig())):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_three_vad_steps_match_the_reference_step():
    cfg, jcfg = vad_m.VADConfig(), jvad.VADConfig()
    rng = np.random.default_rng(1)
    batches = [PV.make_batch(rng, 4, 6, cfg.window) for _ in range(3)]
    jparams = jvad.init_params(jax.random.PRNGKey(42), jcfg)

    # tools/train_vad.py:81-87, the loss over seq_apply (:46-55)
    def loss_fn(p, windows, labels):
        st = jvad.init_state(jcfg, windows.shape[0])
        probs, _ = JV.seq_apply(p, jcfg, windows, st)
        eps = 1e-6
        bce = -(labels * jnp.log(probs + eps) + (1 - labels) * jnp.log(1 - probs + eps))
        return bce.mean(), probs

    lr = 1e-3
    want_losses, want = jax_steps(loss_fn, jparams, optax.adamw(lr, weight_decay=1e-5),
                                  batches, has_aux=True)  # :76
    params = port_params(jparams)
    losses = PV.train(params, cfg, PV.make_optimizer(params, lr), lambda i: batches[i], 3,
                      "cpu", log_every=0)
    assert_losses_close(losses, want_losses)
    assert_tree_close(params, want)


def test_three_amendnet_steps_match_the_reference_step():
    cfg, jcfg = amd.AmendNetConfig(), jamd.AmendNetConfig()
    rng = np.random.default_rng(2)
    batches = [PA.make_batch(rng, 4, cfg) for _ in range(3)]
    jparams = jamd.init_params(jax.random.PRNGKey(42), jcfg)

    # tools/train_amendnet.py:122-124, the loss
    def loss_fn(p, mel, dirty, clean):
        out = jamd.apply(p, jcfg, mel, dirty)
        return jnp.mean(jnp.abs(out - clean))

    lr = 3e-4
    want_losses, want = jax_steps(loss_fn, jparams, optax.adamw(lr, weight_decay=1e-5),
                                  batches)  # :117
    params = port_params(jparams)
    losses = PA.train(params, cfg, PA.make_optimizer(params, lr), lambda i: batches[i], 3,
                      "cpu", log_every=0)
    assert_losses_close(losses, want_losses)
    assert_tree_close(params, want)


def test_vad_state_carries_the_graph_across_windows():
    """Every window's probability depends on the first window's audio
    through the carried state: nothing on the path cuts the graph."""
    cfg = vad_m.VADConfig()
    params = optim.trainable(vad_m.init_params(cfg, torch.Generator().manual_seed(0), "cpu"))
    xw = torch.from_numpy(PV.make_batch(np.random.default_rng(3), 2, 4, cfg.window)[0])
    xw.requires_grad_()
    probs, state = PV.seq_apply(params, cfg, xw, vad_m.init_state(cfg, 2, "cpu"))
    g, = torch.autograd.grad(probs[:, -1].sum(), xw)
    assert g[:, 0].abs().sum() > 0 and state.h.grad_fn is not None


def test_weights_load_through_load_pretrained(tmp_path):
    cfg, acfg = vad_m.VADConfig(), amd.AmendNetConfig()
    vp = optim.trainable(vad_m.init_params(cfg, torch.Generator().manual_seed(0), "cpu"))
    ap_ = optim.trainable(amd.init_params(acfg, torch.Generator().manual_seed(0), "cpu"))
    got_v = vad_m.load_pretrained("cpu", PV.save(str(tmp_path), vp))
    got_a = amd.load_pretrained("cpu", path=PA.save(str(tmp_path), ap_))
    assert torch.equal(got_v["lstm"][1]["wh"], vp["lstm"][1]["wh"].detach())
    assert torch.equal(got_a["conv2"]["w"], ap_["conv2"]["w"].detach())
    # the reference package reads the port's files too
    jv = jvad.load_pretrained(str(tmp_path / PV.WEIGHTS))
    np.testing.assert_array_equal(np.asarray(jv["head"]["w"]), vp["head"]["w"].detach().numpy())
