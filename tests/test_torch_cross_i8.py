"""The int8-direct cross-attention mode of the STT decode (the port's
``STTEngineConfig.cross_int8_direct``) against the JAX package, on the CPU.

The port keeps the canonical int8 cross cache ``{"q": int8 [B, H, S, Dh],
"s": f32 [B, H, S, 1]}``; the reference reads it time-minor, so its entries
are the port's codes and scales transposed (each package quantizes the same
K and V, and the tests hold the two caches equal first).  On the CPU the
op runs its plain version, ``ops.cross_attention_i8._plain_cross_attention_i8``.

Tolerances: fp32, the same integer codes and outputs within 1e-5 (only the
order of the softmax sum and of the q projection's products differs); bf16,
the q projection is rounded to bf16 by each framework's own matmul, so a
code one apart is possible and counted (at most 2% of q's codes and of the
weights' codes, each at most one apart) and the outputs are held within
2^-6 relative L2 (two bf16 steps).  Logits of whole decode steps in fp32
within 1e-4, as ``tests/test_torch_whisper.py``; the engines' average
logprobs within the 1e-3 of the STT engine parity.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infernos_tpu.models import layers as JL
from infernos_tpu.models import presets
from infernos_tpu.models import whisper as jwsp
from infernos_tpu.serving import stt_engine as jstt
from infernos_tpu_torch.models import layers as L
from infernos_tpu_torch.models import whisper as wsp
from infernos_tpu_torch.models.convert import from_jax_params
from infernos_tpu_torch.ops import cross_attention_i8 as xi8
from infernos_tpu_torch.serving import stt_engine as stt

B, H, DH, S = 3, 4, 64, 37
JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"fp32": torch.float32, "bf16": torch.bfloat16}
CODE_SHARE = 0.02  # bf16: share of codes allowed one apart


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mask(kind):
    """None, per-slot lengths, or per-slot lengths with one empty slot."""
    if kind == "none":
        return None
    lens = {"lens": [S, 20, 5], "empty": [S, 0, 9]}[kind]
    return np.arange(S)[None, :] < np.asarray(lens)[:, None]


def _layer_inputs(seed):
    rng = np.random.default_rng(seed)
    D = H * DH
    lin = lambda: {"w": (rng.standard_normal((D, D)) / np.sqrt(D)).astype(np.float32),
                   "b": (0.1 * rng.standard_normal(D)).astype(np.float32)}
    p = {"q": lin(), "o": lin()}
    x = rng.standard_normal((B, 1, D)).astype(np.float32)
    # positions of unlike magnitude, so the per-position scales matter
    k, v = (rng.standard_normal((B, H, S, DH)) * rng.uniform(0.2, 3.0, (B, H, S, 1))
            for _ in range(2))
    return p, x, k.astype(np.float32), v.astype(np.float32)


def _both_caches(k, v):
    """Each package quantizes K and V; the reference's entries time-minor."""
    kc, vc = wsp.quantize_kv(torch.from_numpy(k)), wsp.quantize_kv(torch.from_numpy(v))
    jk, jv = (jwsp.to_time_minor_kv(jwsp.quantize_kv(jnp.asarray(t))) for t in (k, v))
    for c, jc in ((kc, jk), (vc, jv)):
        np.testing.assert_array_equal(c["q"].numpy(), np.swapaxes(np.asarray(jc["q"]), -1, -2))
        np.testing.assert_array_equal(c["s"].numpy(), np.swapaxes(np.asarray(jc["s"]), -1, -2))
    return kc, vc, jk, jv


def _reference_codes(jp, x, jk, jv, mask):
    """q's codes and the weights' codes as the reference computes them
    (``infernos_tpu/models/layers.py`` ``cross_attention_step_i8``)."""
    q = JL.split_heads(JL.linear(x, jp["q"]), H) * DH ** -0.5
    qf = q.astype(jnp.float32)
    qs = jnp.maximum(jnp.max(jnp.abs(qf), axis=-1, keepdims=True), 1e-8) / 127.0
    qq = jnp.clip(jnp.round(qf / qs), -127, 127).astype(jnp.int8)
    acc = jax.lax.dot_general(qq, jk["q"], (((3,), (2,)), ((0, 1), (0, 1))),
                              preferred_element_type=jnp.int32)
    logits = acc.astype(jnp.float32) * qs * jk["s"]
    if mask is not None:
        logits = jnp.where(mask[:, None, None, :], logits, JL.NEG_INF)
    wp = jax.nn.softmax(logits, axis=-1) * jv["s"]
    ws = jnp.maximum(jnp.max(wp, axis=-1, keepdims=True), 1e-20) / 127.0
    wq = jnp.clip(jnp.round(wp / ws), 0, 127).astype(jnp.int8)
    return np.asarray(qq)[:, :, 0], np.asarray(wq)[:, :, 0]


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("mask_kind", ["none", "lens", "empty"])
def test_cross_attention_step_i8_matches_reference(dtype, mask_kind):
    p, x, k, v = _layer_inputs(seed=len(mask_kind) + 10 * (dtype == "bf16"))
    kc, vc, jk, jv = _both_caches(k, v)
    mask = _mask(mask_kind)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, JDT[dtype]), p)
    jx = jnp.asarray(x, JDT[dtype])
    jmask = None if mask is None else jnp.asarray(mask)
    want = np.asarray(JL.cross_attention_step_i8(jp, jx, jk, jv, n_heads=H, kv_mask=jmask)
                      .astype(jnp.float32))
    pp = jax.tree_util.tree_map(lambda a: torch.from_numpy(a).to(TDT[dtype]), p)
    px = torch.from_numpy(x).to(TDT[dtype])
    tmask = None if mask is None else torch.from_numpy(mask)
    got = L.cross_attention_step_i8(pp, px, kc, vc, n_heads=H, kv_mask=tmask)
    assert got.dtype == TDT[dtype] and got.shape == (B, 1, H * DH)

    q = L.split_heads(L.linear(px, pp["q"]), H) * DH ** -0.5
    _, qq, wq = xi8._plain_cross_attention_i8(q, kc, vc, tmask, return_codes=True)
    want_qq, want_wq = _reference_codes(jp, jx, jk, jv, jmask)
    if mask_kind == "empty":  # an empty slot: uniform weights, not NaN
        assert np.isfinite(got.float().numpy()).all()
        wp = np.float32(1.0) / np.float32(S) * vc["s"][1, :, :, 0].numpy()
        ws = wp.max(axis=-1, keepdims=True) / np.float32(127.0)
        np.testing.assert_array_equal(wq[1].numpy(), np.clip(np.rint(wp / ws), 0, 127))
    if dtype == "fp32":
        np.testing.assert_array_equal(qq.numpy(), want_qq)
        np.testing.assert_array_equal(wq.numpy(), want_wq)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    else:
        for mine, ref in ((qq, want_qq), (wq, want_wq)):
            diff = np.abs(mine.numpy().astype(np.int32) - ref.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() <= CODE_SHARE, diff.sum()
        assert _rel_l2(got.float().numpy(), want) <= 2 ** -6


def test_plain_version_widens_to_int32_before_both_products():
    """Every code at 127: q . k is 127 * 127 * 64 and the weights' product
    127 * 127 * S, far past int8 (torch's int8 matmul on the CPU returns
    int8 and wraps); the plain version's sums must be exact."""
    q = torch.ones((1, 1, 1, DH))
    full = lambda shape, val, dt: torch.full(shape, val, dtype=dt)
    k_c = {"q": full((1, 1, S, DH), 127, torch.int8), "s": full((1, 1, S, 1), 0.5, torch.float32)}
    v_c = {"q": full((1, 1, S, DH), 127, torch.int8), "s": full((1, 1, S, 1), 0.25, torch.float32)}
    out, qq, wq = xi8._plain_cross_attention_i8(q, k_c, v_c, return_codes=True)
    assert (qq == 127).all() and (wq == 127).all()  # uniform weights, equal scales
    ws = np.float32(np.float32(1.0 / S) * np.float32(0.25)) / np.float32(127.0)
    want = np.float32(127 * 127 * S) * ws
    np.testing.assert_allclose(out.numpy(), np.full((1, 1, 1, DH), want), rtol=1e-6)
    a = torch.full((4, DH), 127, dtype=torch.int8)
    assert (xi8._widened_dot(a, a) == 127 * 127 * DH).all()


def test_decode_step_direct_matches_reference_decode_step_ring():
    """``whisper.decode_step(cross_direct_int8=True)`` against the
    reference's ``decode_step_ring(time_minor=True, cross_direct_int8=True)``
    over three steps, per-slot positions and an encoder mask (fp32)."""
    jcfg = presets.WHISPER_TINY_TEST
    jparams = jwsp.init_params(jax.random.PRNGKey(1), jcfg)
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    cfg = wsp.WhisperConfig(**{f: getattr(jcfg, f) for f in wsp.WhisperConfig.__dataclass_fields__})
    rng = np.random.default_rng(4)
    Bs, Se, Tmax, K = 3, 30, 12, 3
    enc = rng.standard_normal((Bs, Se, jcfg.d_model)).astype(np.float32)
    jcache = jwsp.fill_cross_kv(
        jparams, jcfg, jwsp.init_cache(jcfg, Bs, Tmax, Se, cross_int8=True, time_minor=True),
        jnp.asarray(enc), time_minor=True)
    cache = wsp.fill_cross_kv(params, cfg, wsp.init_cache(cfg, Bs, Tmax, Se, "cpu", cross_int8=True),
                              torch.from_numpy(enc))
    np.testing.assert_array_equal(cache.cross_v["q"].numpy(),
                                  np.swapaxes(np.asarray(jcache.cross_v["q"]), -1, -2))
    mask = np.arange(Se)[None, :] < np.array([[Se], [17], [0]])
    rk, rv = jwsp.init_ring(jcfg, Bs, K, time_minor=True)
    pos0 = np.array([0, 2, 5], np.int32)
    for step_i in range(K):
        toks = rng.integers(0, jcfg.vocab_size, Bs).astype(np.int32)
        want, rk, rv = jwsp.decode_step_ring(
            jparams, jcfg, jnp.asarray(toks), jcache, rk, rv, jnp.asarray(pos0),
            jnp.asarray(pos0 + step_i), step_i, enc_mask=jnp.asarray(mask),
            time_minor=True, cross_direct_int8=True)
        got = wsp.decode_step(params, cfg, torch.from_numpy(toks), cache,
                              torch.from_numpy(pos0 + step_i).long(),
                              enc_mask=torch.from_numpy(mask), cross_direct_int8=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    with pytest.raises(AssertionError, match="int8 cross cache"):
        wsp.decode_step(params, cfg, torch.from_numpy(toks),
                        wsp.init_cache(cfg, Bs, Tmax, Se, "cpu"),
                        torch.zeros(Bs, dtype=torch.long), cross_direct_int8=True)


# -- the engines --------------------------------------------------------------

TINY_KW = dict(vocab_size=100, num_mel_bins=20, d_model=32, encoder_layers=1,
               encoder_attention_heads=2, decoder_layers=1, decoder_attention_heads=2,
               ffn_dim=64, max_source_positions=100, max_target_positions=64,
               eos_token_id=2, sot_token_id=3, no_speech_token_id=4)
# tests/test_stt_engine.py::test_cross_int8_direct_matches_dequantize's engine
ENGINE_KW = dict(batch_slots=3, buckets_s=(1,), sample_rate=16000, max_new_tokens=6,
                 max_prompt_tokens=8, lang_tokens={"en": 10}, task_transcribe=12,
                 task_translate=13, no_timestamps=14, no_speech=4, cross_kv_int8=True)


def _audio(seconds, seed):
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal(int(16000 * seconds))).astype(np.float32)


def _serve(eng, req_cls):
    out = []
    for seed in (3, 4, 5):
        eng.submit(req_cls(audio=_audio(0.7, seed), text_cb=out.append))
    for _ in range(200):
        if not eng.step():
            break
    return out


@pytest.fixture(scope="module")
def tiny():
    jcfg = jwsp.WhisperConfig(**TINY_KW)
    jparams = jwsp.init_params(jax.random.PRNGKey(0), jcfg)
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return jparams, jcfg, params, wsp.WhisperConfig(**TINY_KW)


def test_stt_engine_direct_mode_same_tokens_as_jax_engine(tiny):
    jparams, jcfg, params, cfg = tiny
    want = _serve(jstt.STTEngine(jparams, jcfg, jstt.STTEngineConfig(
        cache_time_minor=True, cross_int8_direct=True, **ENGINE_KW)), jstt.STTRequest)
    got = _serve(stt.STTEngine(params, cfg, stt.STTEngineConfig(
        cross_int8_direct=True, **ENGINE_KW), device="cpu"), stt.STTRequest)
    assert len(got) == len(want) == 3
    assert [r.tokens for r in got] == [r.tokens for r in want]  # in finishing order
    assert any(r.tokens for r in want)
    for g, w in zip(got, want):
        assert abs(g.avg_logprob - w.avg_logprob) < 1e-3
        assert abs(g.no_speech_prob - w.no_speech_prob) < 1e-4


def test_cross_int8_direct_matches_dequantize(tiny):
    """The port's mirror of the reference's test: the direct mode tracks the
    dequantize path, same greedy tokens and close logprobs."""
    _, _, params, cfg = tiny
    base = stt.STTEngineConfig(**ENGINE_KW)

    def run(ecfg):
        return _serve(stt.STTEngine(params, cfg, ecfg, device="cpu"), stt.STTRequest)

    ref = run(base)
    i8 = run(dataclasses.replace(base, cross_int8_direct=True))
    assert [r.tokens for r in i8] == [r.tokens for r in ref]
    for a, b in zip(i8, ref):
        assert abs(a.avg_logprob - b.avg_logprob) < 0.05


def test_direct_mode_needs_the_int8_cross_cache():
    assert stt.STTEngineConfig().cross_int8_direct is jstt.STTEngineConfig().cross_int8_direct is False
    with pytest.raises(ValueError, match="cross_kv_int8"):
        stt.STTEngineConfig(cross_kv_int8=False, cross_int8_direct=True)
    with pytest.raises(ValueError, match="cross_kv_int8"):
        jstt.STTEngineConfig(cross_kv_int8=False, cross_int8_direct=True)
    # the reference's other condition, time-minor caches, has no field here
    assert stt.STTEngineConfig(cross_int8_direct=True).cross_kv_int8


def test_kernel_wrapper_refuses_what_the_kernel_does_not_take():
    """The checks run before the device: a wrong dtype, a non-contiguous
    cache, a head dim other than 64 or a CPU tensor raise, and nothing
    takes the plain route."""
    _, _, k, v = _layer_inputs(seed=7)
    kc, vc = wsp.quantize_kv(torch.from_numpy(k)), wsp.quantize_kv(torch.from_numpy(v))
    q = torch.randn((B, H, 1, DH))
    bad = [
        ({**kc, "q": kc["q"].to(torch.int16)}, vc, q, "int8 codes"),
        ({**kc, "s": kc["s"].double()}, vc, q, "fp32 scales"),
        (kc, {"q": vc["q"].transpose(2, 3).contiguous().transpose(2, 3), "s": vc["s"]}, q,
         "contiguous"),
        (kc, vc, q.half(), "bf16 or fp32"),
        (kc, vc, torch.randn((B, H, 1, 32)), "q must be"),
        (kc, vc, q, "CUDA device"),
    ]
    for k_c, v_c, qq, msg in bad:
        with pytest.raises(ValueError, match=msg):
            xi8._kernel_cross_attention_i8(qq, k_c, v_c)


def test_reference_gap_sets_the_chip_bound():
    """``chip_smoke.py`` holds one full-width decode step's logits, the
    direct mode against the dequantize path, to ``CROSS_I8_LOGITS_REL_TOL``.
    That bound comes from the reference's own gap: at whisper-large-v3's
    width in bf16 (20 heads of 64, S 1500, random init, the vocabulary cut
    to 4,096 rows) with 4 of its 32 decoder layers, twice the gap grown as
    the square root of the depth to 32 layers must be within the bound and
    at least two thirds of it.  The port's gap on the same inputs is the
    reference's within 10%."""
    import chip_smoke

    n_layers, Bs, Se = 4, 4, 1500
    jcfg = jwsp.WhisperConfig(vocab_size=4096, encoder_layers=1, decoder_layers=n_layers)
    jp = jwsp.init_params(jax.random.PRNGKey(5), jcfg)
    jp = {k: v for k, v in jp.items() if k.startswith(("dec", "tok"))}
    jpb = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jp)
    rng = np.random.default_rng(0)
    enc = jnp.asarray(rng.standard_normal((Bs, Se, jcfg.d_model)), jnp.bfloat16)
    jcache = jwsp.fill_cross_kv(
        jpb, jcfg, jwsp.init_cache(jcfg, Bs, 16, Se, jnp.bfloat16, cross_int8=True,
                                   time_minor=True), enc, time_minor=True)
    mask = np.arange(Se)[None] < np.array([[Se], [700], [150], [0]])
    toks = rng.integers(0, jcfg.vocab_size, Bs).astype(np.int32)
    pos = np.array([0, 3, 5, 1], np.int32)
    rk, rv = jwsp.init_ring(jcfg, Bs, 1, jnp.bfloat16, time_minor=True)
    want = [np.asarray(jwsp.decode_step_ring(
        jpb, jcfg, jnp.asarray(toks), jcache, rk, rv, jnp.asarray(pos), jnp.asarray(pos), 0,
        enc_mask=jnp.asarray(mask), time_minor=True, cross_direct_int8=d)[0].astype(jnp.float32))
        for d in (False, True)]
    ref_gap = _rel_l2(want[1], want[0])
    derived = 2 * ref_gap * np.sqrt(32 / n_layers)
    assert derived <= chip_smoke.CROSS_I8_LOGITS_REL_TOL <= 1.5 * derived, (ref_gap, derived)

    cfg = wsp.WhisperConfig(vocab_size=4096, encoder_layers=1, decoder_layers=n_layers)
    params = jax.tree_util.tree_map(
        lambda t: t.bfloat16(),
        from_jax_params(jax.tree_util.tree_map(lambda a: np.asarray(a.astype(jnp.float32)), jpb),
                        "cpu"))
    cache = wsp.fill_cross_kv(
        params, cfg, wsp.init_cache(cfg, Bs, 16, Se, "cpu", torch.bfloat16, cross_int8=True),
        torch.from_numpy(np.asarray(enc.astype(jnp.float32))).bfloat16())
    got = [wsp.decode_step(params, cfg, torch.from_numpy(toks),
                           dataclasses.replace(cache, self_k=cache.self_k.clone(),
                                               self_v=cache.self_v.clone()),
                           torch.from_numpy(pos).long(), enc_mask=torch.from_numpy(mask),
                           cross_direct_int8=d).float().numpy() for d in (False, True)]
    assert abs(_rel_l2(got[1], got[0]) - ref_gap) <= 0.1 * ref_gap
