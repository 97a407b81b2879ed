"""The port's Qwen2 against a random-init HF ``Qwen2ForCausalLM`` (tiny
config, no download) and against the JAX package, fp32 on the CPU.  Port
copy of ``tests/test_qwen_parity.py`` at its tolerances: ``port_from_hf``
equal to the JAX port's tree (untied and tied embeddings), prefill
(``atol`` 3e-4), incremental steps against prefill (3e-4), prefill K/V
against the steps' K/V (2e-5), greedy against HF ``generate``.  The JAX
file's tensor-parallel case is in ``tests/test_torch_llm_tp.py``.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from infernos_tpu.models import qwen as jq
from infernos_tpu_torch.models import qwen

from test_torch_whisper_parity import assert_trees_equal


def _hf(tie: bool):
    from transformers import Qwen2Config, Qwen2ForCausalLM

    torch.manual_seed(0)
    return Qwen2ForCausalLM(Qwen2Config(
        vocab_size=120, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, intermediate_size=64, max_position_embeddings=128,
        rope_theta=10000.0, tie_word_embeddings=tie, attention_dropout=0.0)).eval()


@pytest.fixture(scope="module")
def hf_model():
    return _hf(False)


@pytest.fixture(scope="module")
def ported(hf_model):
    return qwen.port_from_hf(hf_model)


@pytest.mark.parametrize("tie", [False, True])
def test_port_from_hf_equals_jax_port(tie):
    model = _hf(tie)
    params, cfg = qwen.port_from_hf(model)
    jparams, jcfg = jq.port_from_hf(model)
    assert_trees_equal(jparams, params)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert ("lm_head" in params) == (not tie)


def test_prefill_parity(hf_model, ported):
    params, cfg = ported
    toks = torch.tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, size=(2, 9)))
    with torch.no_grad():
        want = hf_model(toks).logits.numpy()
        got, _, _ = qwen.prefill(params, cfg, toks)
    np.testing.assert_allclose(got.numpy(), want, atol=3e-4)


def test_incremental_matches_prefill(ported):
    params, cfg = ported
    B, T = 2, 7
    toks = torch.tensor(np.random.default_rng(1).integers(0, cfg.vocab_size, size=(B, T)))
    with torch.no_grad():
        want, _, _ = qwen.prefill(params, cfg, toks)
        cache = qwen.init_cache(cfg, B, T + 2)
        outs = []
        for t in range(T):
            logits, cache = qwen.decode_step(params, cfg, toks[:, t], cache, torch.full((B,), t))
            outs.append(logits.numpy())
    np.testing.assert_allclose(np.stack(outs, axis=1), want.numpy(), atol=3e-4)


def test_prefill_kv_matches_step_kv(ported):
    """Prefill's K/V equal what incremental steps write (the LLM engine's
    join path depends on this)."""
    params, cfg = ported
    B, T = 1, 5
    toks = torch.tensor(np.random.default_rng(2).integers(0, cfg.vocab_size, size=(B, T)))
    with torch.no_grad():
        _, ks, vs = qwen.prefill(params, cfg, toks)
        cache = qwen.init_cache(cfg, B, T)
        for t in range(T):
            _, cache = qwen.decode_step(params, cfg, toks[:, t], cache, torch.full((B,), t))
    np.testing.assert_allclose(cache.k.numpy(), ks.numpy(), atol=2e-5)
    np.testing.assert_allclose(cache.v.numpy(), vs.numpy(), atol=2e-5)


def test_greedy_matches_hf_generate(hf_model, ported):
    params, cfg = ported
    prompt = torch.tensor(np.random.default_rng(4).integers(0, cfg.vocab_size, size=(1, 5)))
    T = prompt.shape[1]
    with torch.no_grad():
        want = hf_model.generate(prompt, max_new_tokens=6, do_sample=False,
                                 num_beams=1)[0].tolist()
        logits, ks, vs = qwen.prefill(params, cfg, prompt)
        cache = qwen.init_cache(cfg, 1, T + 8)
        cache.k[:, :, :, :T] = ks
        cache.v[:, :, :, :T] = vs
        toks = prompt[0].tolist() + [int(logits[0, -1].argmax())]
        for t in range(5):
            logits1, cache = qwen.decode_step(params, cfg, torch.tensor([toks[-1]]), cache,
                                              torch.tensor([T + t]))
            toks.append(int(logits1[0].argmax()))
    assert toks[: len(want)] == want[: len(toks)], (toks, want)


def test_untied_or_unread_keys_raise():
    model = _hf(True)
    for key, value in (("lm_head.weight", None), ("model.extra.weight", torch.zeros(2))):
        sd = dict(model.state_dict())
        sd[key] = sd[key] + 1.0 if value is None else value
        with pytest.raises(ValueError, match=key.split(".")[1]):
            qwen.port_from_hf(types.SimpleNamespace(config=model.config,
                                                    state_dict=lambda sd=sd: sd))
    sd = dict(model.state_dict())  # an older checkpoint's saved RoPE buffer
    sd["model.layers.0.self_attn.rotary_emb.inv_freq"] = torch.zeros(4)
    qwen.port_from_hf(types.SimpleNamespace(config=model.config, state_dict=lambda: sd))
