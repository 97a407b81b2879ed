"""Port's SpeechT5 text encoder, prenet, postnet, HiFi-GAN and AmendNet vs
the JAX reference, on the in-repo trained tiny TTS checkpoints and the
vendored AmendNet weights, fp32 (tolerance 1e-4: fp32 round-off through a
few layers)."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from infernos_tpu.models import amendnet as jamd
from infernos_tpu.models import hifigan as jhfg
from infernos_tpu.models import speecht5 as jst5
from infernos_tpu.models.npz_io import data_path, load_params
from infernos_tpu.models.tiny_real import _load_cfg
from infernos_tpu_torch.models import amendnet as amd
from infernos_tpu_torch.models import hifigan as hfg
from infernos_tpu_torch.models import speecht5 as st5
from infernos_tpu_torch.models.convert import from_jax_params

TOL = dict(atol=1e-4, rtol=1e-4)
D = data_path("tiny_tts")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(tree):
    return from_jax_params(jax.tree_util.tree_map(np.asarray, tree), "cpu")


def _same_cfg(cls, jcfg):
    return cls(**{f: getattr(jcfg, f) for f in cls.__dataclass_fields__})


@pytest.fixture(scope="module")
def t5():
    jparams = load_params(os.path.join(D, "t5_params.npz"))
    jcfg = _load_cfg(D, jst5.SpeechT5Config)
    return jparams, jcfg, _port(jparams), _same_cfg(st5.SpeechT5Config, jcfg)


def test_encode_text(t5):
    jparams, jcfg, params, cfg = t5
    rng = np.random.default_rng(0)
    ids = rng.integers(2, jcfg.vocab_size, (2, 12)).astype(np.int32)
    mask = np.ones((2, 12), np.int32)
    mask[1, 8:] = 0
    want = jst5.encode_text(jparams, jcfg, jnp.asarray(ids), jnp.asarray(mask))
    got = st5.encode_text(params, cfg, torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("dropout", ["off", "same_mask"])
def test_decoder_prenet(t5, dropout):
    jparams, jcfg, params, cfg = t5
    rng = np.random.default_rng(1)
    mel = rng.standard_normal((3, 1, jcfg.num_mel_bins)).astype(np.float32)
    spk = rng.standard_normal((3, jcfg.speaker_embedding_dim)).astype(np.float32)
    off = np.array([0, 5, 17], np.int32)
    t = lambda a: torch.from_numpy(a)
    if dropout == "off":
        want = jst5.decoder_prenet(jparams, jcfg, jnp.asarray(mel), jnp.asarray(spk),
                                   step_offset=jnp.asarray(off))
        got = st5.decoder_prenet(params, cfg, t(mel), t(spk), step_offset=t(off))
    else:
        # replay the reference's own draws and hand the port the same masks
        key = jax.random.PRNGKey(3)
        want = jst5.decoder_prenet(jparams, jcfg, jnp.asarray(mel), jnp.asarray(spk),
                                   step_offset=jnp.asarray(off), dropout_rng=key)
        masks, rk = [], key
        for _ in range(jcfg.speech_decoder_prenet_layers):
            rk, sub = jax.random.split(rk)
            masks.append(torch.from_numpy(np.array(jax.random.bernoulli(
                sub, jcfg.speech_decoder_prenet_dropout,
                (1, jcfg.speech_decoder_prenet_units)))))
        got = st5.decoder_prenet(params, cfg, t(mel), t(spk), step_offset=t(off),
                                 dropout_masks=masks)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_feat_prob_and_postnet(t5):
    jparams, jcfg, params, cfg = t5
    rng = np.random.default_rng(2)
    hid = rng.standard_normal((2, 3, jcfg.hidden_size)).astype(np.float32)
    jm, jl = jst5.feat_and_prob(jparams, jcfg, jnp.asarray(hid))
    m, lg = st5.feat_and_prob(params, cfg, torch.from_numpy(hid))
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), **TOL)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **TOL)
    mel = rng.standard_normal((2, 20, jcfg.num_mel_bins)).astype(np.float32)
    want = jst5.postnet(jparams, jcfg, jnp.asarray(mel))
    got = st5.postnet(params, cfg, torch.from_numpy(mel))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_hifigan_tiny_real():
    jparams = load_params(os.path.join(D, "voc_params.npz"))
    jcfg = _load_cfg(D, jhfg.HifiGanConfig, "voc_config.json")
    cfg = _same_cfg(hfg.HifiGanConfig, jcfg)
    mel = np.random.default_rng(4).standard_normal(
        (2, 12, jcfg.model_in_dim)).astype(np.float32)
    want = jhfg.apply(jparams, jcfg, jnp.asarray(mel))
    got = hfg.apply(_port(jparams), cfg, torch.from_numpy(mel))
    assert got.shape == (2, 12 * cfg.total_upsample)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_amendnet_vendored_weights():
    jparams = jamd.load_pretrained()
    params = amd.load_pretrained("cpu")
    jcfg = jamd.AmendNetConfig(chunk_frames=8, pre_frames=4, post_frames=0)
    cfg = _same_cfg(amd.AmendNetConfig, jcfg)
    rng = np.random.default_rng(5)
    mel = rng.standard_normal((2, 12, 80)).astype(np.float32)
    audio = (0.3 * rng.standard_normal((2, 12 * 256))).astype(np.float32)
    want = jamd.apply(jparams, jcfg, jnp.asarray(mel), jnp.asarray(audio))
    got = amd.apply(params, cfg, torch.from_numpy(mel), torch.from_numpy(audio))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_init_params_key_paths_match_reference():
    """Seeded torch init yields the reference's key paths and leaf shapes."""
    jcfg = jst5.SpeechT5Config(
        vocab_size=20, hidden_size=32, encoder_layers=1, encoder_attention_heads=4,
        encoder_ffn_dim=48, decoder_layers=2, decoder_attention_heads=4,
        decoder_ffn_dim=48, num_mel_bins=8, speech_decoder_prenet_units=16,
        speech_decoder_postnet_units=16, speech_decoder_postnet_layers=2,
        speaker_embedding_dim=8, max_text_positions=16, max_speech_positions=32,
        encoder_max_relative_position=8)
    jshapes = jax.tree_util.tree_map(
        lambda a: tuple(a.shape),
        jax.eval_shape(lambda k: jst5.init_params(k, jcfg), jax.random.PRNGKey(0)))
    params = st5.init_params(_same_cfg(st5.SpeechT5Config, jcfg),
                             torch.Generator().manual_seed(0), "cpu")
    shapes = jax.tree_util.tree_map(lambda t: tuple(t.shape), params)
    assert shapes == jshapes


def test_speaker_bank_and_char_tokenizer_match_reference():
    """The TTS engine's inputs: synthetic voices and character ids."""
    from infernos_tpu.models.tokenizers import CharTokenizer as JCharTokenizer
    from infernos_tpu.serving.speakers import SpeakerBank as JSpeakerBank
    from infernos_tpu_torch.models.tokenizers import CharTokenizer
    from infernos_tpu_torch.serving.speakers import SpeakerBank

    bank, jbank = SpeakerBank.synthetic(dim=16, n=50), JSpeakerBank.synthetic(dim=16, n=50)
    assert len(bank) == len(jbank) == 50
    for i in (0, 7, 49, 123):
        np.testing.assert_array_equal(bank.get(i), jbank.get(i))
    text = "Hello, World! It's 3:30 -- ok?"
    np.testing.assert_array_equal(CharTokenizer()(text), JCharTokenizer()(text))
    assert CharTokenizer().vocab_size == JCharTokenizer().vocab_size
