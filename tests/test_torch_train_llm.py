"""The port's tiny LLM trainer against ``tools/train_tiny_llm.py``.

The policy, dialogues, examples and batches must equal the reference
trainer's (bit for bit, for the same numpy seed); three steps from the JAX
init must match a reference step written from its ``loss_fn``
(``tools/train_tiny_llm.py:278-281``) and optax chain (``:270-273``) at fp32
within 1e-4 relative; the greedy replies of the vendored checkpoint must be
the reference's; the checkpoint serves through ``load_tiny_llm``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from infernos_tpu.models import qwen as jqwen
from infernos_tpu.models.tokenizers import ByteTokenizer as JByteTokenizer
from infernos_tpu_torch.models.tokenizers import ByteTokenizer
from infernos_tpu_torch.tools import optim
from infernos_tpu_torch.tools import train_tiny_llm as P
from tools import train_tiny_llm as J

from torch_train_ref import (assert_losses_close, assert_tree_close, jax_steps,
                             port_params)


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_policy_dialogues_and_config_match_the_reference():
    for u in ("transfer me to sales please", "my account number is one two",
              "<sentence interrupted>", "", "thanks goodbye", "what is my order status"):
        assert P.policy(u) == J.policy(u)
    for seed in range(5):
        assert P.make_dialogue(np.random.default_rng(seed)) == \
            J.make_dialogue(np.random.default_rng(seed))
    cfg, jcfg = P.tiny_config(), J.tiny_config()
    assert {k: getattr(cfg, k) for k in cfg.__dataclass_fields__} == \
        {k: getattr(jcfg, k) for k in jcfg.__dataclass_fields__}


@pytest.mark.parametrize("seed", [0, 7])
def test_batches_are_the_reference_trainers_bit_for_bit(seed):
    got = P.make_batch(np.random.default_rng(seed), ByteTokenizer(), 5)
    want = J.make_batch(np.random.default_rng(seed), JByteTokenizer(), 5)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_three_steps_match_the_reference_step():
    steps, lr = 3, 3e-4
    jcfg = J.tiny_config()
    rng = np.random.default_rng(2)
    batches = [P.make_batch(rng, ByteTokenizer(), 2) for _ in range(steps)]
    jparams = jqwen.init_params(jax.random.PRNGKey(0), jcfg)

    # tools/train_tiny_llm.py:278-281, the loss
    def loss_fn(p, toks, tgt, mask):
        logits, _, _ = jqwen.prefill(p, jcfg, toks[:, :-1])
        ll = optax.softmax_cross_entropy_with_integer_labels(logits, tgt)
        return (ll * mask).sum() / jnp.maximum(mask.sum(), 1.0)

    # :270-273, the optax chain
    warm = min(300, max(1, steps // 10))
    sched = optax.warmup_cosine_decay_schedule(0.0, lr, warm, steps, lr * 0.02)
    want_losses, want = jax_steps(loss_fn, jparams, optax.adamw(sched, weight_decay=1e-4),
                                  batches)
    params = port_params(jparams)
    losses = P.train(params, P.tiny_config(), P.make_optimizer(params, lr, steps),
                     lambda i: batches[i], steps, "cpu", log_every=0)
    assert_losses_close(losses, want_losses)
    assert_tree_close(params, want)


def test_greedy_replies_of_the_vendored_checkpoint_match_the_reference():
    from infernos_tpu.models.npz_io import load_params as jload
    from infernos_tpu_torch.models.npz_io import data_path, load_params

    path = f"{data_path('tiny_llm')}/params.npz"
    contexts = [c for c, _ in J.make_dialogue(np.random.default_rng(10_000))][:2]
    got = P.greedy_replies(load_params(path, "cpu", torch.float32), P.tiny_config(),
                           ByteTokenizer(), contexts, max_new=12)
    want = J.greedy_replies(jload(path), J.tiny_config(), JByteTokenizer(), contexts,
                            max_new=12)
    assert got == want and all(got)


def test_checkpoint_serves_through_the_loader(tmp_path, monkeypatch):
    from infernos_tpu_torch.models import qwen, tiny_real

    cfg = P.tiny_config()
    params = optim.trainable(qwen.init_params(cfg, torch.Generator().manual_seed(0), "cpu"))
    P.save(str(tmp_path), params, cfg)
    monkeypatch.setenv("INFERNOS_TINY_DATA_TINY_LLM", str(tmp_path))
    got, gcfg = tiny_real.load_tiny_llm(device="cpu")
    assert gcfg == cfg
    assert torch.equal(got["embed"]["w"], params["embed"]["w"].detach())
