"""The port's Whisper against a random-init HF ``WhisperForConditionalGeneration``
(built from a tiny config, no download) and against the JAX package, fp32 on
the CPU.  Port copy of ``tests/test_whisper_parity.py`` at its tolerances:

- ``port_from_hf`` gives the JAX ``port_from_hf``'s tree of the same HF model
  exactly (fp32, same key paths) and the same config;
- encoder (``atol`` 3e-5) and teacher-forced ``decode_full`` (2e-4) against HF;
- cached ``decode_step`` steps against ``decode_full`` (2e-4);
- greedy decode against HF ``generate``;
- ``decode_full`` against the JAX ``decode_full`` on the same params (1e-5);
- a state dict with a key the port does not read, or a ``proj_out`` not tied
  to the embedding, raises.
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infernos_tpu.models import whisper as jw
from infernos_tpu_torch.models import whisper as wsp

DEV = "cpu"


@pytest.fixture(scope="module")
def hf_model():
    from transformers import WhisperConfig, WhisperForConditionalGeneration

    torch.manual_seed(0)
    cfg = WhisperConfig(
        vocab_size=100, num_mel_bins=20, d_model=48, encoder_layers=2,
        encoder_attention_heads=4, decoder_layers=2, decoder_attention_heads=4,
        encoder_ffn_dim=96, decoder_ffn_dim=96, max_source_positions=60,
        max_target_positions=40, dropout=0.0, attention_dropout=0.0,
        activation_dropout=0.0, pad_token_id=0, bos_token_id=1, eos_token_id=2,
        decoder_start_token_id=3)
    return WhisperForConditionalGeneration(cfg).eval()


@pytest.fixture(scope="module")
def ported(hf_model):
    with torch.no_grad():
        return wsp.port_from_hf(hf_model)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, path + (i,))
    else:
        yield path, tree


def assert_trees_equal(jax_tree, torch_tree):
    a, b = dict(_flat(jax_tree)), dict(_flat(torch_tree))
    assert a.keys() == b.keys()
    for k in a:
        want = np.asarray(a[k])
        got = b[k].numpy()
        assert got.dtype == want.dtype == np.float32, k
        np.testing.assert_array_equal(got, want, err_msg=str(k))


def test_port_from_hf_equals_jax_port(hf_model, ported):
    params, cfg = ported
    jparams, jcfg = jw.port_from_hf(hf_model)
    assert_trees_equal(jparams, params)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)


def test_encoder_parity(hf_model, ported):
    params, cfg = ported
    mel = np.random.default_rng(0).standard_normal((2, cfg.num_mel_bins, 120)).astype(np.float32)
    with torch.no_grad():
        want = hf_model.model.encoder(torch.tensor(mel)).last_hidden_state.numpy()
        got = wsp.encode(params, cfg, torch.tensor(mel)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=3e-5)


def test_decoder_full_parity(hf_model, ported):
    params, cfg = ported
    rng = np.random.default_rng(1)
    mel = rng.standard_normal((2, cfg.num_mel_bins, 120)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 7))
    with torch.no_grad():
        enc = hf_model.model.encoder(torch.tensor(mel)).last_hidden_state
        want = hf_model(decoder_input_ids=torch.tensor(toks, dtype=torch.long),
                        encoder_outputs=(enc,)).logits.numpy()
        got = wsp.decode_full(params, cfg, torch.tensor(toks),
                              wsp.encode(params, cfg, torch.tensor(mel))).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_incremental_matches_full(ported):
    params, cfg = ported
    rng = np.random.default_rng(2)
    B, S, T = 2, 30, 6
    enc = torch.tensor(rng.standard_normal((B, S, cfg.d_model)).astype(np.float32))
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, size=(B, T)))
    with torch.no_grad():
        want = wsp.decode_full(params, cfg, toks, enc).numpy()
        cache = wsp.fill_cross_kv(params, cfg, wsp.init_cache(cfg, B, T + 2, S, DEV), enc)
        got = np.stack([wsp.decode_step(params, cfg, toks[:, t], cache,
                                        torch.full((B,), t)).numpy()
                        for t in range(T)], axis=1)
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_greedy_matches_hf_generate(hf_model, ported):
    """End-to-end greedy decode reproduces HF ``generate`` (random weights)."""
    params, cfg = ported
    mel = np.random.default_rng(3).standard_normal((1, cfg.num_mel_bins, 120)).astype(np.float32)
    sot = cfg.sot_token_id
    gen_cfg = hf_model.generation_config
    gen_cfg.forced_decoder_ids = None
    gen_cfg.begin_suppress_tokens = None
    gen_cfg.suppress_tokens = None
    with torch.no_grad():
        want = hf_model.generate(torch.tensor(mel), max_new_tokens=8, do_sample=False,
                                 num_beams=1)[0].tolist()
        enc = wsp.encode(params, cfg, torch.tensor(mel))
        cache = wsp.fill_cross_kv(params, cfg, wsp.init_cache(cfg, 1, 16, enc.shape[1], DEV),
                                  enc)
        got = [sot]
        for t in range(8):
            logits = wsp.decode_step(params, cfg, torch.tensor([got[-1]]), cache,
                                     torch.tensor([t]))
            got.append(int(logits.argmax()))
            if got[-1] == cfg.eos_token_id:
                break
    # HF may omit the start token from the returned sequence
    want_gen = [t for t in want if t != sot]
    got_gen = got[1:]
    n = min(len(want_gen), len(got_gen))
    assert n >= 4 and got_gen[:n] == want_gen[:n], (got, want)


def test_decode_full_matches_jax(ported):
    """The same params and inputs through both packages' ``decode_full``,
    with an encoder padding mask: within 1e-5 (fp32, two summation orders)."""
    params, cfg = ported
    rng = np.random.default_rng(4)
    B, S, T = 2, 20, 9
    enc = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, size=(B, T))
    mask = np.ones((B, S), np.int32)
    mask[1, 13:] = 0
    jtree = {k: _to_jax(v) for k, v in params.items()}
    jcfg = jw.WhisperConfig(**dataclasses.asdict(cfg))
    want = np.asarray(jw.decode_full(jtree, jcfg, jnp.asarray(toks), jnp.asarray(enc),
                                     enc_mask=jnp.asarray(mask)))
    with torch.no_grad():
        got = wsp.decode_full(params, cfg, torch.tensor(toks), torch.tensor(enc),
                              enc_mask=torch.tensor(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_jax(v) for v in tree]
    return jnp.asarray(tree.numpy())


def _standin(hf_model, sd):
    return types.SimpleNamespace(config=hf_model.config,
                                 generation_config=hf_model.generation_config,
                                 state_dict=lambda: sd)


def test_unread_key_raises(hf_model):
    sd = dict(hf_model.state_dict())
    sd["model.encoder.layers.0.self_attn.rotary.weight"] = torch.zeros(3)
    with pytest.raises(ValueError, match="rotary"):
        wsp.port_from_hf(_standin(hf_model, sd))


def test_untied_readout_raises(hf_model):
    sd = dict(hf_model.state_dict())
    sd["proj_out.weight"] = sd["proj_out.weight"] + 1.0
    with pytest.raises(ValueError, match="proj_out"):
        wsp.port_from_hf(_standin(hf_model, sd))
