"""The port's tiny STT trainer against ``tools/train_tiny_stt.py``.

The tokenizer, config and batches must equal the reference trainer's (bit
for bit, for the same numpy seed); three training steps from the JAX init
must match a reference step written from the trainer's ``loss_fn``
(``tools/train_tiny_stt.py:334-339``) and optax chain (``:326-329``), at
fp32 within 1e-4 relative; the trainer's checkpoint must serve through
``load_tiny_stt``; and it never writes under ``infernos_tpu/``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from infernos_tpu.models import whisper as jwsp
from infernos_tpu_torch.tools import optim
from infernos_tpu_torch.tools import train_tiny_stt as P
from tools import train_tiny_stt as J

from torch_train_ref import (assert_losses_close, assert_tree_close, jax_steps,
                             port_params)


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def toks():
    return P.build_tokenizer(), J.build_tokenizer()


def test_tokenizer_config_and_prompt_match_the_reference(toks):
    tok, jtok = toks
    assert tok.special == jtok.special and tok.vocab_size == jtok.vocab_size
    text = "por favor help now"
    assert tok.encode(text) == jtok.encode(text)
    cfg, jcfg = P.tiny_config(tok), J.tiny_config(jtok)
    assert {k: getattr(cfg, k) for k in cfg.__dataclass_fields__} == \
        {k: getattr(jcfg, k) for k in jcfg.__dataclass_fields__}
    for lang in ("en", "pt"):
        assert P.serving_prompt(tok, [5, 6], lang) == J.serving_prompt(jtok, [5, 6], lang)


@pytest.mark.parametrize("seed", [0, 11])
def test_batches_are_the_reference_trainers_bit_for_bit(toks, seed):
    tok, jtok = toks
    got = P.make_batch(np.random.default_rng(seed), tok, 3)
    want = J.make_batch(np.random.default_rng(seed), jtok, 3)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_three_steps_match_the_reference_step(toks):
    tok, jtok = toks
    jcfg = J.tiny_config(jtok)
    cfg = P.tiny_config(tok)
    rng = np.random.default_rng(5)
    batches = [P.make_batch(rng, tok, 2) for _ in range(3)]
    jparams = jwsp.init_params(jax.random.PRNGKey(0), jcfg)
    steps, lr = 3, 3e-4

    # tools/train_tiny_stt.py:334-339, the loss
    def loss_fn(p, mel, toks_, tgt, mask):
        enc = jwsp.encode(p, jcfg, mel)
        logits = jwsp.decode_full(p, jcfg, toks_[:, :-1], enc)
        ll = optax.softmax_cross_entropy_with_integer_labels(logits, tgt)
        return (ll * mask).sum() / jnp.maximum(mask.sum(), 1.0)

    # :326-329, the optax chain
    warm = min(300, max(1, steps // 10))
    sched = optax.warmup_cosine_decay_schedule(0.0, lr, warm, steps, lr * 0.02)
    want_losses, want = jax_steps(loss_fn, jparams, optax.adamw(sched, weight_decay=1e-4),
                                  batches)

    params = port_params(jparams)
    opt = P.make_optimizer(params, lr, steps)
    losses = P.train(params, cfg, opt, lambda i: batches[i], steps, "cpu", log_every=0)
    assert_losses_close(losses, want_losses)
    assert_tree_close(params, want)
    # optax reads the schedule at count 0 first: the warmup's 0.0 leaves
    # the first update's parameters where they were, in both
    assert opt.count == 3 and sched(0) == 0.0


def test_greedy_decode_of_the_vendored_checkpoint_matches_the_reference(toks):
    from infernos_tpu.models.npz_io import load_params as jload
    from infernos_tpu_torch.models.npz_io import data_path, load_params

    tok, jtok = toks
    path = os.path.join(data_path("tiny_stt"), "params.npz")
    params = load_params(path, "cpu", torch.float32)
    jparams = jload(path)
    rng = np.random.default_rng(3)
    mels, texts = [], []
    for _ in range(2):
        audio, text = P.make_utterance(rng, n_words=(1, 3), lang="en")
        mels.append(P.log_mel_np(audio, P.N_MELS)[0])
        texts.append(text)
    mel = np.zeros((2, P.N_MELS, P.MAX_MEL_T), np.float32)
    for i, m in enumerate(mels):
        mel[i, :, : m.shape[1]] = m
    got = P.greedy_decode(params, P.tiny_config(tok), tok, mel, max_new=12)
    want = J.greedy_decode(jparams, J.tiny_config(jtok), jtok, mel, max_new=12)
    assert got == want and any(got)


def test_checkpoint_serves_through_the_loader(tmp_path, toks, monkeypatch):
    from infernos_tpu_torch.models import tiny_real

    tok = toks[0]
    cfg = P.tiny_config(tok)
    params = optim.trainable(P.wsp.init_params(cfg, torch.Generator().manual_seed(1), "cpu"))
    P.save(str(tmp_path), params, cfg, tok)
    monkeypatch.setenv("INFERNOS_TINY_DATA_TINY_STT", str(tmp_path))
    got, gcfg, gtok, ecfg = tiny_real.load_tiny_stt(device="cpu")
    assert gcfg == cfg and gtok.special == tok.special
    assert ecfg.lang_tokens["pt"] == tok.special["<|lang_pt|>"]
    assert torch.equal(got["enc_layers"]["attn"]["q"]["w"],
                       params["enc_layers"]["attn"]["q"]["w"].detach())
    assert json.load(open(tmp_path / "corpus.json"))["words"] == list(P.WORDS)


def test_trainers_refuse_to_write_under_the_reference_package(tmp_path):
    ref = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "infernos_tpu")
    for bad in (ref, os.path.join(ref, "models", "data", "tiny_stt")):
        with pytest.raises(ValueError, match="JAX package"):
            optim.check_out(bad)
        with pytest.raises(ValueError, match="JAX package"):
            P.main(["--out", bad, "--device", "cpu", "--steps", "1"])
    assert optim.default_out("tiny_stt").endswith(
        os.path.join("infernos_tpu_torch", "build", "trained", "tiny_stt"))
    assert optim.check_out(str(tmp_path)) == os.path.realpath(tmp_path)
