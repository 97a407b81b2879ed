"""The port's SpeechT5 and HiFi-GAN against random-init HF
``SpeechT5ForTextToSpeech`` / ``SpeechT5HifiGan`` models (tiny configs, no
download) and against the JAX package, fp32 on the CPU.  Port copy of
``tests/test_speecht5_parity.py`` at its tolerances:

- ``port_from_hf`` of both models gives the JAX ``port_from_hf``'s trees
  exactly (fp32, same key paths) and the same configs;
- text encoder (``atol`` 2e-5), prenet (2e-5), ``decode_full`` (3e-5), heads
  and postnet (3e-5) against HF; cached steps against ``decode_full``
  (3e-5); HiFi-GAN (2e-5);
- ``decode_full`` and its cross-attention weights against the JAX
  ``decode_full`` on the same params (1e-5);
- an unread state-dict key raises.
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infernos_tpu.models import hifigan as jh
from infernos_tpu.models import speecht5 as js
from infernos_tpu_torch.models import hifigan as hfg
from infernos_tpu_torch.models import speecht5 as st5

from test_torch_whisper_parity import _to_jax, assert_trees_equal


@pytest.fixture(scope="module")
def hf_tts():
    from transformers import SpeechT5Config, SpeechT5ForTextToSpeech

    torch.manual_seed(0)
    cfg = SpeechT5Config(
        vocab_size=41, hidden_size=48, encoder_layers=2, encoder_attention_heads=4,
        encoder_ffn_dim=96, decoder_layers=2, decoder_attention_heads=4,
        decoder_ffn_dim=96, num_mel_bins=20, speech_decoder_prenet_units=32,
        speech_decoder_prenet_layers=2, speech_decoder_prenet_dropout=0.0,
        speech_decoder_postnet_units=32, speech_decoder_postnet_layers=3,
        speech_decoder_postnet_kernel=5, reduction_factor=2, speaker_embedding_dim=16,
        max_text_positions=64, max_speech_positions=128, encoder_max_relative_position=20,
        positional_dropout=0.0, hidden_dropout=0.0, attention_dropout=0.0,
        activation_dropout=0.0)
    model = SpeechT5ForTextToSpeech(cfg).eval()
    # always-on prenet dropout with p=0 zeroes activations in HF; bypass it
    # so both sides compute the deterministic prenet
    model.speecht5.decoder.prenet._consistent_dropout = lambda x, p: x
    return model


@pytest.fixture(scope="module")
def hf_vocoder():
    from transformers import SpeechT5HifiGan, SpeechT5HifiGanConfig

    torch.manual_seed(0)
    return SpeechT5HifiGan(SpeechT5HifiGanConfig(
        model_in_dim=20, upsample_initial_channel=32, upsample_rates=[4, 4],
        upsample_kernel_sizes=[8, 8], resblock_kernel_sizes=[3, 7],
        resblock_dilation_sizes=[[1, 3], [1, 3]])).eval()


@pytest.fixture(scope="module")
def ported(hf_tts):
    return st5.port_from_hf(hf_tts)


def test_port_from_hf_equals_jax_port(hf_tts, ported, hf_vocoder):
    params, cfg = ported
    jparams, jcfg = js.port_from_hf(hf_tts)
    assert_trees_equal(jparams, params)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    vparams, vcfg = hfg.port_from_hf(hf_vocoder)
    jvparams, jvcfg = jh.port_from_hf(hf_vocoder)
    assert_trees_equal(jvparams, vparams)
    assert dataclasses.asdict(vcfg) == dataclasses.asdict(jvcfg)


def test_encoder_parity(hf_tts, ported):
    params, cfg = ported
    ids = np.random.default_rng(0).integers(2, cfg.vocab_size, size=(2, 11))
    with torch.no_grad():
        want = hf_tts.speecht5.encoder(torch.tensor(ids)).last_hidden_state.numpy()
        got = st5.encode_text(params, cfg, torch.tensor(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_prenet_and_decoder_parity(hf_tts, ported):
    params, cfg = ported
    rng = np.random.default_rng(1)
    B, S, T = 2, 11, 7
    ids = torch.tensor(rng.integers(2, cfg.vocab_size, size=(B, S)))
    mel = torch.tensor(rng.standard_normal((B, T, cfg.num_mel_bins)).astype(np.float32))
    spk = torch.tensor(rng.standard_normal((B, cfg.speaker_embedding_dim)).astype(np.float32))
    with torch.no_grad():
        enc = hf_tts.speecht5.encoder(ids).last_hidden_state
        pre = hf_tts.speecht5.decoder.prenet(mel, spk)
        dec = hf_tts.speecht5.decoder.wrapped_decoder(
            hidden_states=pre, encoder_hidden_states=enc).last_hidden_state
        before, after, logits = hf_tts.speech_decoder_postnet(dec)

        enc_p = st5.encode_text(params, cfg, ids)
        pre_p = st5.decoder_prenet(params, cfg, mel, spk,
                                   step_offset=torch.zeros(B, dtype=torch.long))
        np.testing.assert_allclose(pre_p.numpy(), pre.numpy(), atol=2e-5)
        dec_p = st5.decode_full(params, cfg, pre_p, enc_p)
        np.testing.assert_allclose(dec_p.numpy(), dec.numpy(), atol=3e-5)
        mel_p, logits_p = st5.feat_and_prob(params, cfg, dec_p)
        np.testing.assert_allclose(mel_p.numpy(), before.numpy(), atol=3e-5)
        np.testing.assert_allclose(logits_p.numpy(), logits.numpy(), atol=3e-5)
        post_p = st5.postnet(params, cfg, mel_p)
        np.testing.assert_allclose(post_p.numpy(), after.numpy(), atol=3e-5)


def test_incremental_decode_matches_full(ported):
    """The slot-batched cached step reproduces the teacher-forced decode."""
    params, cfg = ported
    rng = np.random.default_rng(2)
    B, S, T = 2, 9, 6
    enc = torch.tensor(rng.standard_normal((B, S, cfg.hidden_size)).astype(np.float32))
    dec_in = torch.tensor(rng.standard_normal((B, T, cfg.hidden_size)).astype(np.float32))
    with torch.no_grad():
        want = st5.decode_full(params, cfg, dec_in, enc)
        cache = st5.fill_cross_kv(params, cfg, st5.init_cache(cfg, B, T + 2, S, "cpu"), enc)
        got = torch.cat([st5.decode_step(params, cfg, dec_in[:, t:t + 1], cache,
                                         torch.full((B,), t)) for t in range(T)], dim=1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=3e-5)


def test_decode_full_matches_jax(ported):
    """Both packages' ``decode_full`` on the same params, with a text
    padding mask, and the cross-attention weights it returns: within 1e-5."""
    params, cfg = ported
    rng = np.random.default_rng(4)
    B, S, T = 2, 10, 8
    enc = rng.standard_normal((B, S, cfg.hidden_size)).astype(np.float32)
    dec_in = rng.standard_normal((B, T, cfg.hidden_size)).astype(np.float32)
    mask = np.ones((B, S), np.int32)
    mask[0, 7:] = 0
    jcfg = js.SpeechT5Config(**dataclasses.asdict(cfg))
    want, want_w = js.decode_full(_to_jax(params), jcfg, jnp.asarray(dec_in), jnp.asarray(enc),
                                  enc_mask=jnp.asarray(mask), return_cross_attn=True)
    with torch.no_grad():
        got, got_w = st5.decode_full(params, cfg, torch.tensor(dec_in), torch.tensor(enc),
                                     enc_mask=torch.tensor(mask), return_cross_attn=True)
        plain = st5.decode_full(params, cfg, torch.tensor(dec_in), torch.tensor(enc),
                                enc_mask=torch.tensor(mask))
    assert got_w.shape == (cfg.decoder_layers, B, cfg.decoder_attention_heads, T, S)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), atol=1e-5)
    np.testing.assert_array_equal(plain.numpy(), got.numpy())


def test_hifigan_parity(hf_vocoder):
    params, cfg = hfg.port_from_hf(hf_vocoder)
    mel = np.random.default_rng(3).standard_normal((2, 12, 20)).astype(np.float32)
    with torch.no_grad():
        want = hf_vocoder(torch.tensor(mel)).numpy()
        got = hfg.apply(params, cfg, torch.tensor(mel)).numpy()
    assert got.shape == want.shape == (2, 12 * cfg.total_upsample)
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_unread_key_raises(hf_tts, hf_vocoder):
    for mod, model, extra in ((st5, hf_tts, "speecht5.encoder.prenet.extra.weight"),
                              (hfg, hf_vocoder, "upsampler.9.weight")):
        sd = dict(model.state_dict())
        sd[extra] = torch.zeros(2)
        with pytest.raises(ValueError, match="not read"):
            mod.port_from_hf(types.SimpleNamespace(config=model.config,
                                                   state_dict=lambda sd=sd: sd))
