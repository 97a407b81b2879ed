"""Port's SpeechT5 decoder step (plain path on CPU) vs the JAX reference.

Same setup as ``tests/test_tts_fused_step.py``: random caches, per-slot
positions, an encoder mask.  Against ``speecht5.decode_step`` the port must
agree to fp32 round-off (1e-5); against the JAX Pallas kernel (interpret
mode), which packs its weights in bf16, to 2e-2.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from infernos_tpu.models import speecht5 as jst5
from infernos_tpu.ops.tts_step import fused_decode_step as jax_fused_step
from infernos_tpu_torch.models import speecht5 as st5
from infernos_tpu_torch.models.convert import from_jax_params
from infernos_tpu_torch.ops.tts_step import (fused_decode_step,
                                             pack_fused_weights)

CFG_KW = dict(
    vocab_size=40, hidden_size=64, encoder_layers=1,
    encoder_attention_heads=4, encoder_ffn_dim=96, decoder_layers=3,
    decoder_attention_heads=4, decoder_ffn_dim=96, num_mel_bins=8,
    speech_decoder_prenet_units=16, speech_decoder_postnet_units=16,
    speaker_embedding_dim=16, max_text_positions=16,
    max_speech_positions=64)
JCFG = jst5.SpeechT5Config(**CFG_KW)
CFG = st5.SpeechT5Config(**CFG_KW)
B, TMAX, S = 4, 16, 8
FP32 = dict(atol=1e-5, rtol=1e-5)
BF16 = dict(atol=2e-2, rtol=2e-2)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(seed):
    jparams = jst5.init_params(jax.random.PRNGKey(seed), JCFG)
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(seed)
    shape_s = (JCFG.decoder_layers, B, 4, TMAX, 16)
    shape_c = (JCFG.decoder_layers, B, 4, S, 16)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in (shape_s, shape_s, shape_c, shape_c)]
    mask = np.tril(np.ones((B, S)))[:, ::-1].copy().astype(bool)
    mask[:, :2] = True
    return jparams, params, arrs, mask


def _jcache(arrs):
    return jst5.DecoderCache(*(jnp.asarray(a) for a in arrs))


def _tcache(arrs):
    return st5.DecoderCache(*(torch.from_numpy(a.copy()) for a in arrs))


def _x(seed):
    return np.random.default_rng(1000 + seed).standard_normal(
        (B, 1, 64)).astype(np.float32)


@pytest.mark.parametrize("pos", [[0, 0, 0, 0], [0, 3, 7, 12], [15, 1, 8, 4]])
def test_step_matches_jax(pos):
    jparams, params, arrs, mask = _setup(0)
    x = _x(0)
    jpos = jnp.asarray(pos, jnp.int32)
    h_ref, c_ref = jst5.decode_step(jparams, JCFG, jnp.asarray(x), _jcache(arrs),
                                    jpos, enc_mask=jnp.asarray(mask))
    h_pal, c_pal = jax_fused_step(jparams, JCFG, jnp.asarray(x), _jcache(arrs),
                                  jpos, enc_mask=jnp.asarray(mask), chunk=8,
                                  interpret=True)
    cache = _tcache(arrs)
    h = fused_decode_step(params, CFG, torch.from_numpy(x), cache,
                          torch.tensor(pos), enc_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), **FP32)
    np.testing.assert_allclose(cache.self_k.numpy(), np.asarray(c_ref.self_k), **FP32)
    np.testing.assert_allclose(cache.self_v.numpy(), np.asarray(c_ref.self_v), **FP32)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_pal), **BF16)
    np.testing.assert_allclose(cache.self_k.numpy(), np.asarray(c_pal.self_k), **BF16)
    # only row pos of each slot changed
    changed = np.any(cache.self_k.numpy() != arrs[0], axis=(0, 2, 4))  # [B, T]
    want = np.zeros((B, TMAX), bool)
    want[np.arange(B), pos] = True
    np.testing.assert_array_equal(changed, want)


def test_step_no_enc_mask():
    jparams, params, arrs, _ = _setup(3)
    x, pos = _x(3), [0, 3, 7, 12]
    h_ref, _ = jst5.decode_step(jparams, JCFG, jnp.asarray(x), _jcache(arrs),
                                jnp.asarray(pos, jnp.int32))
    h_pal, _ = jax_fused_step(jparams, JCFG, jnp.asarray(x), _jcache(arrs),
                              jnp.asarray(pos, jnp.int32), chunk=8,
                              interpret=True)
    h = fused_decode_step(params, CFG, torch.from_numpy(x), _tcache(arrs),
                          torch.tensor(pos))
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), **FP32)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_pal), **BF16)


def test_multi_iteration_tracks_jax():
    """Three chained steps with pre-packed weights: cache evolution and
    hidden states track ``speecht5.decode_step``."""
    jparams, params, arrs, mask = _setup(7)
    jcache, cache = _jcache(arrs), _tcache(arrs)
    packed = pack_fused_weights(params, CFG)
    pos = np.array([0, 3, 7, 12])
    for it in range(3):
        x = _x(100 + it)
        h_ref, jcache = jst5.decode_step(jparams, JCFG, jnp.asarray(x), jcache,
                                         jnp.asarray(pos, jnp.int32),
                                         enc_mask=jnp.asarray(mask))
        h = fused_decode_step(params, CFG, torch.from_numpy(x), cache,
                              torch.from_numpy(pos),
                              enc_mask=torch.from_numpy(mask), packed=packed)
        np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), **FP32)
        pos = pos + 1
    np.testing.assert_allclose(cache.self_v.numpy(), np.asarray(jcache.self_v), **FP32)


def test_plain_model_step_matches_jax():
    """The model module's own plain ``decode_step`` (unpacked weights)."""
    jparams, params, arrs, mask = _setup(11)
    x, pos = _x(11), [15, 1, 8, 4]
    h_ref, c_ref = jst5.decode_step(jparams, JCFG, jnp.asarray(x), _jcache(arrs),
                                    jnp.asarray(pos, jnp.int32),
                                    enc_mask=jnp.asarray(mask))
    cache = _tcache(arrs)
    h = st5.decode_step(params, CFG, torch.from_numpy(x), cache,
                        torch.tensor(pos), enc_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), **FP32)
    np.testing.assert_allclose(cache.self_k.numpy(), np.asarray(c_ref.self_k), **FP32)


# -- int8-weight mode ---------------------------------------------------------
# Set up as tests/test_tts_fused_step.py::test_fused_step_int8_matches_quantized_oracle:
# the decoder layers quantized with min_size=0, chunk=8, pos [0, 3, 7, 12].

INT8 = dict(atol=2e-2, rtol=2e-2)  # the JAX test's own tolerance


def _int8_setup(seed):
    from infernos_tpu.models import quant as jquant

    jparams, _, arrs, mask = _setup(seed)
    jq = dict(jparams)
    jq["dec_layers"] = jquant.quantize_params(jparams["dec_layers"], min_size=0)
    qparams = from_jax_params(jax.tree_util.tree_map(np.asarray, jq), "cpu")
    return jq, qparams, arrs, mask


@pytest.mark.parametrize("pos", [[0, 3, 7, 12], [15, 1, 8, 4]])
def test_int8_step_matches_jax_kernel_and_oracle(pos):
    jq, qparams, arrs, mask = _int8_setup(11)
    assert qparams["dec_layers"]["self_attn"]["q"]["w_q"].dtype == torch.int8
    x = _x(11)
    jpos = jnp.asarray(pos, jnp.int32)
    h_ref, c_ref = jst5.decode_step(jq, JCFG, jnp.asarray(x), _jcache(arrs),
                                    jpos, enc_mask=jnp.asarray(mask))
    h_pal, c_pal = jax_fused_step(jq, JCFG, jnp.asarray(x), _jcache(arrs),
                                  jpos, enc_mask=jnp.asarray(mask), chunk=8,
                                  interpret=True)
    cache = _tcache(arrs)
    h = fused_decode_step(qparams, CFG, torch.from_numpy(x), cache,
                          torch.tensor(pos), enc_mask=torch.from_numpy(mask))
    for want_h, want_c in ((h_pal, c_pal), (h_ref, c_ref)):
        np.testing.assert_allclose(h.numpy(), np.asarray(want_h), **INT8)
        np.testing.assert_allclose(cache.self_k.numpy(), np.asarray(want_c.self_k), **INT8)
        np.testing.assert_allclose(cache.self_v.numpy(), np.asarray(want_c.self_v), **INT8)
    # against the oracle on the same quantized tree the plain step is fp32
    # arithmetic in another order: far inside the kernel's tolerance
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), atol=1e-4, rtol=1e-4)
    changed = np.any(cache.self_k.numpy() != arrs[0], axis=(0, 2, 4))  # [B, T]
    want = np.zeros((B, TMAX), bool)
    want[np.arange(B), pos] = True
    np.testing.assert_array_equal(changed, want)
    # the model module's own plain step takes the quantized tree through linear()
    cache2 = _tcache(arrs)
    h2 = st5.decode_step(qparams, CFG, torch.from_numpy(x), cache2,
                         torch.tensor(pos), enc_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(h2.numpy(), np.asarray(h_ref), **FP32)


def test_int8_step_differs_from_dense_step():
    """The mode is live: the quantized tree's step is not the dense one's."""
    jparams, params, arrs, mask = _setup(11)
    _, qparams, _, _ = _int8_setup(11)
    x, pos = torch.from_numpy(_x(11)), torch.tensor([0, 3, 7, 12])
    hd = fused_decode_step(params, CFG, x, _tcache(arrs), pos,
                           enc_mask=torch.from_numpy(mask))
    hq = fused_decode_step(qparams, CFG, x, _tcache(arrs), pos,
                           enc_mask=torch.from_numpy(mask))
    err = (hd - hq).abs().max().item()
    assert 1e-4 < err < 0.2


def test_pack_fused_weights_int8_matches_jax_layout():
    from infernos_tpu.ops import tts_step as jts
    from infernos_tpu_torch.ops.tts_step import is_int8

    jq, qparams, _, _ = _int8_setup(5)
    jfw = jts.pack_fused_weights(jq, JCFG)
    fw = pack_fused_weights(qparams, CFG, torch.bfloat16)  # dtype: no effect on codes
    assert is_int8(fw) and not is_int8(pack_fused_weights(_setup(5)[1], CFG))
    Lyr, H, D = JCFG.decoder_layers, JCFG.decoder_attention_heads, 64

    def codes(name, want):
        assert fw[name].dtype == torch.int8 and fw[name].is_contiguous()
        np.testing.assert_array_equal(fw[name].numpy(), np.asarray(want))

    codes("wqkv", jfw.wqkv)
    # the JAX kernel keeps the output projections head-major [L, H, Dh, D]
    codes("wso", np.asarray(jfw.sow).reshape(Lyr, D, D))
    codes("wco", np.asarray(jfw.cow).reshape(Lyr, D, D))
    codes("wcq", jfw.cqw)
    codes("w1", jfw.w1)
    codes("w2", jfw.w2)
    for name, want in (("sqkv", jfw.sqkv_s), ("sso", jfw.so_s), ("scq", jfw.cq_s),
                       ("sco", jfw.co_s), ("s1", jfw.w1_s), ("s2", jfw.w2_s),
                       ("bqkv", jfw.bqkv), ("b1", jfw.b1)):
        assert fw[name].dtype == torch.float32
        np.testing.assert_allclose(fw[name].numpy(), np.asarray(want), rtol=1e-6, atol=0)
    # the attention scale sits in the q third of the scales, not in the codes
    sa = qparams["dec_layers"]["self_attn"]
    np.testing.assert_array_equal(fw["wqkv"][:, :, :D].numpy(), sa["q"]["w_q"].numpy())
    np.testing.assert_allclose(fw["sqkv"][:, :D].numpy(),
                               sa["q"]["scale"].numpy() * (D // H) ** -0.5, rtol=1e-6)
    np.testing.assert_allclose(fw["sqkv"][:, D:2 * D].numpy(), sa["k"]["scale"].numpy(),
                               rtol=0, atol=0)


def test_int8_multi_iteration_tracks_oracle_with_packed_weights():
    jq, qparams, arrs, mask = _int8_setup(7)
    jcache, cache = _jcache(arrs), _tcache(arrs)
    packed = pack_fused_weights(qparams, CFG)
    pos = np.array([0, 3, 7, 12])
    for it in range(3):
        x = _x(200 + it)
        h_ref, jcache = jst5.decode_step(jq, JCFG, jnp.asarray(x), jcache,
                                         jnp.asarray(pos, jnp.int32),
                                         enc_mask=jnp.asarray(mask))
        h = fused_decode_step(qparams, CFG, torch.from_numpy(x), cache,
                              torch.from_numpy(pos),
                              enc_mask=torch.from_numpy(mask), packed=packed)
        np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), atol=1e-4, rtol=1e-4)
        pos = pos + 1
    np.testing.assert_allclose(cache.self_v.numpy(), np.asarray(jcache.self_v),
                               atol=1e-4, rtol=1e-4)
