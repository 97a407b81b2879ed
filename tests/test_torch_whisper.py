"""Port's Whisper model vs the JAX reference, on the unit-test config and on
the in-repo trained tiny checkpoint (``tiny_stt/params.npz``), fp32."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from infernos_tpu.models import presets
from infernos_tpu.models import whisper as jwsp
from infernos_tpu.models.npz_io import data_path, load_params
from infernos_tpu.models.tiny_real import _load_cfg
from infernos_tpu_torch.models import whisper as wsp
from infernos_tpu_torch.models.convert import from_jax_params

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_test():
    jcfg = presets.WHISPER_TINY_TEST
    return jwsp.init_params(jax.random.PRNGKey(0), jcfg), jcfg


def _tiny_real():
    d = data_path("tiny_stt")
    return load_params(os.path.join(d, "params.npz")), _load_cfg(d, jwsp.WhisperConfig)


def _port(jparams, jcfg):
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    cfg = wsp.WhisperConfig(**{f: getattr(jcfg, f) for f in
                               wsp.WhisperConfig.__dataclass_fields__})
    return params, cfg


@pytest.mark.parametrize("which", ["tiny_test", "tiny_real"])
def test_encode_cross_kv_and_decode_step(which):
    jparams, jcfg = _tiny_test() if which == "tiny_test" else _tiny_real()
    params, cfg = _port(jparams, jcfg)
    rng = np.random.default_rng(0)
    B, T = 2, 200
    mel = rng.standard_normal((B, jcfg.num_mel_bins, T)).astype(np.float32)
    enc_ref = np.asarray(jwsp.encode(jparams, jcfg, jnp.asarray(mel)))
    enc = wsp.encode(params, cfg, torch.from_numpy(mel))
    np.testing.assert_allclose(enc.numpy(), enc_ref, **TOL)

    S, Tmax = enc_ref.shape[1], 12
    jcache = jwsp.fill_cross_kv(jparams, jcfg,
                                jwsp.init_cache(jcfg, B, Tmax, S),
                                jnp.asarray(enc_ref))
    cache = wsp.fill_cross_kv(params, cfg, wsp.init_cache(cfg, B, Tmax, S, "cpu"),
                              torch.from_numpy(enc_ref.copy()))
    np.testing.assert_allclose(cache.cross_k.numpy(), np.asarray(jcache.cross_k), **TOL)
    np.testing.assert_allclose(cache.cross_v.numpy(), np.asarray(jcache.cross_v), **TOL)

    mask = np.ones((B, S), bool)
    mask[1, S - 20:] = False
    pos = np.array([0, 0])
    for it in range(3):
        toks = rng.integers(0, jcfg.vocab_size, B).astype(np.int32)
        lg_ref, jcache = jwsp.decode_step(jparams, jcfg, jnp.asarray(toks), jcache,
                                          jnp.asarray(pos, jnp.int32),
                                          enc_mask=jnp.asarray(mask))
        lg = wsp.decode_step(params, cfg, torch.from_numpy(toks), cache,
                             torch.from_numpy(pos), enc_mask=torch.from_numpy(mask))
        np.testing.assert_allclose(lg.numpy(), np.asarray(lg_ref), **TOL)
        pos = pos + np.array([1, 2])
    np.testing.assert_allclose(cache.self_k.numpy(), np.asarray(jcache.self_k), **TOL)


def test_quantize_kv_round_trip_matches_jax():
    x = np.random.default_rng(1).standard_normal((2, 3, 7, 16)).astype(np.float32)
    q = wsp.quantize_kv(torch.from_numpy(x))
    jq = jwsp.quantize_kv(jnp.asarray(x))
    np.testing.assert_array_equal(q["q"].numpy(), np.asarray(jq["q"]))
    np.testing.assert_allclose(q["s"].numpy(), np.asarray(jq["s"]), rtol=1e-6)
    back = wsp.dequantize_kv(q, torch.float32).numpy()
    # symmetric int8: error at most half a step of each position's scale
    assert np.all(np.abs(back - x) <= q["s"].numpy() / 2 + 1e-7)
    np.testing.assert_allclose(
        back, np.asarray(jwsp.dequantize_kv(jq, jnp.float32)), rtol=1e-6, atol=1e-7)


def test_int8_cross_cache_decode_matches_jax():
    jparams, jcfg = _tiny_test()
    params, cfg = _port(jparams, jcfg)
    enc = np.random.default_rng(2).standard_normal((2, 30, jcfg.d_model)).astype(np.float32)
    jcache = jwsp.fill_cross_kv(jparams, jcfg,
                                jwsp.init_cache(jcfg, 2, 8, 30, cross_int8=True),
                                jnp.asarray(enc))
    cache = wsp.fill_cross_kv(params, cfg,
                              wsp.init_cache(cfg, 2, 8, 30, "cpu", cross_int8=True),
                              torch.from_numpy(enc))
    np.testing.assert_array_equal(cache.cross_k["q"].numpy(),
                                  np.asarray(jcache.cross_k["q"]))
    toks, pos = np.array([3, 5], np.int32), np.array([0, 4])
    lg_ref, _ = jwsp.decode_step(jparams, jcfg, jnp.asarray(toks), jcache,
                                 jnp.asarray(pos, jnp.int32))
    lg = wsp.decode_step(params, cfg, torch.from_numpy(toks), cache,
                         torch.from_numpy(pos))
    np.testing.assert_allclose(lg.numpy(), np.asarray(lg_ref), **TOL)
