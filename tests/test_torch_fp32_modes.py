"""The fp32 modes of the port's two kernels, and the dtype rule that picks them.

The reference's two Pallas sites take the dtype of their inputs on the TPU:
``_attn_kernel`` runs in q's dtype, ``_layer_kernel`` takes its cache
dtypes from the caches.  The tiny and tiny-real engines and the trainers
run them in fp32 there, the full-width engines in bf16.  The CUDA kernels
run only on the card (``tests/test_torch_kernels.py``, marked ``cuda``, holds
them to their plain versions there); here:

- kernel 1: the port's plain attention in fp32 against JAX
  ``_pallas_attention(..., interpret=True)`` on fp32 inputs at the
  tiny-real encoder's width (4 heads of 64, S 250 padded to 256 in JAX,
  per-row key masks), fp32 round-off (1e-5); the wrapper takes all-fp32
  inputs as far as the device check;
- kernel 2: the plain step over fp32 caches, its weights rounded to bf16
  as the reference's ``wdt`` rounds them (or int8 codes), against JAX
  ``fused_decode_step(..., interpret=True)`` over ``tm_init_cache(...,
  dtype=jnp.float32)`` caches, three steps in a row.  Tolerance 2e-2, the
  reference's own for its kernel against fp32 (``tests/test_tts_fused_step.py``):
  the Pallas kernel rounds each product's activations to bf16, the plain
  step keeps them fp32; the weights and the cache rows are the same
  values in both.  The wrapper takes four fp32 caches as far as the
  device check and refuses a mix;
- the dtype rule (``models/tiny_real.serving_dtype``) at every call site,
  asked for ``torch.device("cuda")`` (nothing is allocated) and for the
  CPU, against the dtype the JAX counterpart uses on a TPU and on the CPU.
"""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from infernos_tpu.cluster import model_actors as jma
from infernos_tpu.models import speecht5 as jst5
from infernos_tpu.ops import tts_step as jts
from infernos_tpu.ops.attention import NEG_INF as JNEG_INF
from infernos_tpu.ops.attention import _pallas_attention
from infernos_tpu.serving.llm_engine import LLMEngineConfig as JLLMConfig
from infernos_tpu.serving.stt_engine import STTEngineConfig as JSTTConfig
from infernos_tpu.serving.tts_engine import TTSEngineConfig as JTTSConfig
from infernos_tpu_torch.models import speecht5 as st5
from infernos_tpu_torch.models import tiny_real
from infernos_tpu_torch.models.convert import from_jax_params
from infernos_tpu_torch.ops import attention as attn
from infernos_tpu_torch.ops import tts_step as ts

FP32 = dict(atol=1e-5, rtol=1e-5)
KERNEL_VS_FP32 = dict(atol=2e-2, rtol=2e-2)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- kernel 1 --------------------------------------------------------------------

def test_plain_fp32_attention_matches_jax_pallas_at_tiny_real_width():
    """Two utterances of the 5 s bucket (S 250), 4 heads of 64, a key mask
    per utterance: the JAX kernel on ``[B * 4, 256, 64]`` padded with masked
    keys and sliced back, the port's plain version on ``[B, 250, 256]``."""
    B, S, H, Dh = 2, 250, 4, 64
    rng = np.random.default_rng(17)
    q, k, v = (rng.standard_normal((B, S, H * Dh)).astype(np.float32) for _ in range(3))
    mask = np.arange(S)[None] < np.array([[S], [131]])
    got = attn.by_heads(attn._plain_attention, *(torch.from_numpy(a) for a in (q, k, v)),
                        n_heads=H, mask=torch.from_numpy(mask))
    assert got.dtype == torch.float32

    def split(a):  # [B, S, H * Dh] -> [B * H, 256, Dh], zero rows past S
        a = a.reshape(B, S, H, Dh).transpose(0, 2, 1, 3).reshape(B * H, S, Dh)
        return jnp.pad(jnp.asarray(a), ((0, 0), (0, 256 - S), (0, 0)))

    madd = np.where(mask, 0.0, JNEG_INF).astype(np.float32).repeat(H, axis=0)
    madd = jnp.pad(jnp.asarray(madd), ((0, 0), (0, 256 - S)), constant_values=JNEG_INF)
    out = _pallas_attention(split(q), split(k), split(v), madd, block_q=128, interpret=True)
    assert out.dtype == jnp.float32  # the kernel's dtype is q's
    want = np.asarray(out)[:, :S].reshape(B, H, S, Dh).transpose(0, 2, 1, 3).reshape(B, S, H * Dh)
    np.testing.assert_allclose(got.numpy(), want, **FP32)


def test_kernel_wrapper_takes_all_fp32_inputs_as_far_as_the_device():
    """fp32 thirds of a fused ``[B, S, 3D]`` projection pass every check but
    the device's (16-byte rows: 4 fp32 values); the strides handed to the
    kernel are the tensor's own."""
    q, k, v = torch.zeros((2, 16, 3 * 128)).split(128, dim=-1)
    assert attn._kernel_args(q, k, v, torch.zeros((2, 16)), 2) == (2, 16, [16 * 384, 64, 384] * 3)
    assert attn._ENTRIES[q.dtype] == "attn_fwd_fp32"
    before = (attn.fused_attention.launches, attn.fused_attention.launches_fp32)
    with pytest.raises(ValueError, match="CUDA"):
        attn._kernel_attention(q, k, v, torch.zeros((2, 16)), n_heads=2)
    assert (attn.fused_attention.launches, attn.fused_attention.launches_fp32) == before


# -- kernel 2 --------------------------------------------------------------------

CFG_KW = dict(
    vocab_size=40, hidden_size=128, encoder_layers=1, encoder_attention_heads=2,
    encoder_ffn_dim=256, decoder_layers=2, decoder_attention_heads=2, decoder_ffn_dim=256,
    num_mel_bins=8, speech_decoder_prenet_units=16, speech_decoder_postnet_units=16,
    speaker_embedding_dim=16, max_text_positions=16, max_speech_positions=64)
JCFG, CFG = jst5.SpeechT5Config(**CFG_KW), st5.SpeechT5Config(**CFG_KW)
B, T, S, CHUNK = 4, 16, 8, 8


def _trees(int8: bool, seed: int = 3):
    jparams = jst5.init_params(jax.random.PRNGKey(seed), JCFG)
    if int8:
        from infernos_tpu.models import quant as jquant

        jparams = dict(jparams)
        jparams["dec_layers"] = jquant.quantize_params(jparams["dec_layers"], min_size=0)
    return jparams, from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), "cpu")


@pytest.mark.parametrize("int8", [False, True], ids=["bf16_weights", "int8_weights"])
def test_plain_step_over_fp32_caches_matches_jax_kernel(int8):
    jparams, params = _trees(int8)
    # the weights as the reference packs them: bf16 (wdt) or the int8 codes
    fw = ts.pack_fused_weights(params, CFG, torch.bfloat16)
    assert ts.is_int8(fw) == int8
    assert fw["wqkv"].dtype == (torch.int8 if int8 else torch.bfloat16)
    rng = np.random.default_rng(5)
    Lyr, H, Dh = JCFG.decoder_layers, JCFG.decoder_attention_heads, JCFG.head_dim
    arrs = [rng.standard_normal((Lyr, B, H, t, Dh)).astype(np.float32) for t in (T, T, S, S)]
    jcache = jts.to_time_minor(jst5.DecoderCache(*(jnp.asarray(a) for a in arrs)), CHUNK)
    empty = jts.tm_init_cache(JCFG, B, T, S, dtype=jnp.float32, chunk=CHUNK)
    for a, e in zip(jcache, empty):  # the serving layout, fp32
        assert a.shape == e.shape and a.dtype == e.dtype == jnp.float32
    cache = st5.DecoderCache(*(torch.from_numpy(a.copy()) for a in arrs))
    mask = np.arange(S)[None] < np.array([[8], [1], [5], [3]])
    jpacked = jts.pack_fused_weights(jparams, JCFG)
    jstep = jax.jit(lambda x, c, p: jts.fused_decode_step(
        jparams, JCFG, x, c, p, enc_mask=jnp.asarray(mask), chunk=CHUNK, interpret=True,
        time_minor=True, packed=jpacked))  # traced once for the three steps
    pos = np.array([0, 3, 7, 12])
    for it in range(3):  # chained: positions advance, caches carry over
        x = np.random.default_rng(100 + it).standard_normal((B, 1, 128)).astype(np.float32)
        hj, jcache = jstep(jnp.asarray(x), jcache, jnp.asarray(pos, jnp.int32))
        h = ts.fused_decode_step(params, CFG, torch.from_numpy(x), cache,
                                 torch.from_numpy(pos), enc_mask=torch.from_numpy(mask),
                                 packed=fw)
        assert h.dtype == torch.float32
        np.testing.assert_allclose(h.numpy(), np.asarray(hj), **KERNEL_VS_FP32)
        pos = pos + 1
    jc = jts.from_time_minor(jcache, T, S)
    assert jc.self_k.dtype == jnp.float32 and cache.self_k.dtype == torch.float32
    for name in ("self_k", "self_v"):
        np.testing.assert_allclose(getattr(cache, name).numpy(), np.asarray(getattr(jc, name)),
                                   **KERNEL_VS_FP32)
    # rows other than the three written per slot are untouched in both
    written = np.zeros((B, T), bool)
    for it in range(3):
        written[np.arange(B), np.array([0, 3, 7, 12]) + it] = True
    changed = np.any(cache.self_k.numpy() != arrs[0], axis=(0, 2, 4))
    np.testing.assert_array_equal(changed, written)
    np.testing.assert_array_equal(np.asarray(jc.cross_k), arrs[2])


def _panelled_args(cdt):
    params = st5.init_params(CFG, torch.Generator().manual_seed(5), "cpu")
    fw = ts.pack_fused_weights(params, CFG, torch.bfloat16)
    fw.update({n: ts.pack_panels(fw[n]) for n in ts._GEMMS})  # the card's layout
    cache = st5.init_cache(CFG, 2, T, S, "cpu", dtype=cdt)
    return fw, cache, torch.zeros((2, 1, 128)), torch.zeros(2, dtype=torch.long)


def test_step_wrapper_takes_fp32_caches_as_far_as_the_device():
    fw, cache, x, pos = _panelled_args(torch.float32)
    assert ts._check_step_args(fw, x, cache, pos, None)[:2] == (2, 2)
    assert ts._MODES[(False, torch.float32)] == ("tts_decode_step_fp32", "launches_fp32")
    assert ts._MODES[(True, torch.float32)] == ("tts_decode_step_int8_fp32",
                                                "launches_int8_fp32")
    with pytest.raises(ValueError, match="CUDA"):
        ts._kernel_decode_step(fw, CFG, x, cache, pos)


@pytest.mark.parametrize("odd", ["self_v", "cross_k"])
def test_step_wrapper_refuses_mixed_cache_dtypes(odd):
    fw, cache, x, pos = _panelled_args(torch.float32)
    cache = dataclasses.replace(cache, **{odd: getattr(cache, odd).to(torch.bfloat16)})
    with pytest.raises(ValueError, match="share one dtype"):
        ts._check_step_args(fw, x, cache, pos, None)


def test_pack_fused_weights_keeps_the_dtype_asked_for_on_the_cpu():
    """The card packs bf16 whatever is asked (the kernel's weights, the
    reference's ``wdt``); the CPU's plain step keeps the engine's dtype, as
    the reference's CPU path never rounds them."""
    params = st5.init_params(CFG, torch.Generator().manual_seed(6), "cpu")
    assert ts.pack_fused_weights(params, CFG)["wqkv"].dtype == torch.float32
    assert ts.pack_fused_weights(params, CFG, torch.float32)["w1"].dtype == torch.float32
    assert ts.pack_fused_weights(params, CFG, torch.bfloat16)["w1"].dtype == torch.bfloat16


# -- the dtype rule ----------------------------------------------------------------

PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "infernos_tpu_torch")


def _jax_serving_dtype(monkeypatch, platform: str) -> str:
    """The reference's ``_serving_dtype()`` with its first device on
    ``platform``."""
    class Dev:
        pass

    d = Dev()
    d.platform = platform
    monkeypatch.setattr(jax, "devices", lambda *a: [d])
    got = jnp.dtype(jma._serving_dtype())
    assert got in (jnp.dtype(jnp.bfloat16), jnp.dtype(jnp.float32))
    return "bf16" if got == jnp.dtype(jnp.bfloat16) else "fp32"


def _jax_default(cfg) -> str:
    assert jnp.dtype(cfg().dtype) == jnp.dtype(jnp.float32)
    return "fp32"


BF16_ON_TPU = ("bf16", "fp32")  # the benches' `bfloat16 if on_tpu else float32`
# (call site, port file, the call there, its `tiny`, the JAX counterpart's
# (TPU, CPU) dtype: "serving" is model_actors._serving_dtype(), a config class
# its default, a pair itself)
SITES = [
    ("TTSActor tiny", "cluster/model_actors.py", "dtype = serving_dtype(dev, tiny=self.tiny)",
     True, ("fp32", "fp32")),  # model_actors.py:104 `jnp.float32 if self.tiny`
    ("TTSActor full", "cluster/model_actors.py", "dtype = serving_dtype(dev, tiny=self.tiny)",
     False, "serving"),
    ("TTSActor tiny-real", "cluster/model_actors.py", "dtype=serving_dtype(dev, tiny=True),",
     True, ("fp32", "fp32")),  # model_actors.py:159
    ("STTActor tiny", "cluster/model_actors.py", "dtype = serving_dtype(dev, tiny=self.tiny)",
     True, JSTTConfig),  # model_actors.py:222-228, no dtype
    ("STTActor full", "cluster/model_actors.py", "dtype = serving_dtype(dev, tiny=self.tiny)",
     False, "serving"),
    ("LLMActor tiny", "cluster/model_actors.py", "dtype = serving_dtype(dev, tiny=self.tiny)",
     True, JLLMConfig),  # model_actors.py:346-349
    ("LLMActor full", "cluster/model_actors.py", "dtype = serving_dtype(dev, tiny=self.tiny)",
     False, "serving"),
    ("LLMActor tiny-real", "cluster/model_actors.py",
     "dtype=serving_dtype(dev, tiny=True))", True, JLLMConfig),
    ("load_tiny_stt", "models/tiny_real.py", "dtype = serving_dtype(dev, tiny=True)",
     True, JSTTConfig),  # tiny_real.py:76, no dtype
    ("load_tiny_tts", "models/tiny_real.py", "dtype = serving_dtype(dev, tiny=True)",
     True, ("fp32", "fp32")),
    ("load_tiny_llm", "models/tiny_real.py", "serving_dtype(dev, tiny=True))",
     True, ("fp32", "fp32")),
    ("check_bilingual", "tools/check_bilingual.py", "serving_dtype(device, tiny=True)",
     True, JTTSConfig),
    ("port_checkpoints --dry-run", "tools/port_checkpoints.py",
     "serving_dtype(dev, tiny=True)", True, ("fp32", "fp32")),
    ("sttbench", "bench/sttbench.py", "serving_dtype(device, tiny=not full)", True, JSTTConfig),
    ("sttbench --full", "bench/sttbench.py", "serving_dtype(device, tiny=not full)",
     False, JSTTConfig),
    ("ttsmain", "bench/ttsmain.py", "serving_dtype(device, tiny=False)", False, BF16_ON_TPU),
    ("llmbench", "bench/llmbench.py", "serving_dtype(dev, tiny=False)", False, BF16_ON_TPU),
    ("ttsprobe", "bench/ttsprobe.py", "serving_dtype(dev, tiny=False)", False, BF16_ON_TPU),
    ("aiabench --full", "bench/aiabench.py", "serving_dtype(dev, tiny=False)",
     False, ("bf16", "bf16")),  # aiabench.py:166
    ("loopback", "bench/loopback.py", "serving_dtype(device, tiny=True)", True, JTTSConfig),
    ("ttsbench", "bench/ttsbench.py", "serving_dtype(dev, tiny=tiny)", True, JTTSConfig),
    ("ttsbench --full", "bench/ttsbench.py", "serving_dtype(dev, tiny=tiny)", False, JTTSConfig),
    ("llm_test", "examples/llm_test.py", "serving_dtype(dev, tiny=tiny)", True, JLLMConfig),
    ("llm_test --full", "examples/llm_test.py", "serving_dtype(dev, tiny=tiny)",
     False, JLLMConfig),
    ("tts_stream", "examples/tts_stream.py", "serving_dtype(dev, tiny=tiny)", True, JTTSConfig),
    ("tts_stream --full", "examples/tts_stream.py", "serving_dtype(dev, tiny=tiny)",
     False, JTTSConfig),
]
# Full-width sites whose JAX counterpart sets no serving dtype (its engine
# config's fp32 default, or bf16 pinned on every device): the port applies
# the full-width rule there, bf16 on the card and fp32 on the CPU.
FULL_WIDTH_RULE = {"sttbench --full", "ttsbench --full", "llm_test --full",
                   "tts_stream --full", "aiabench --full"}


@pytest.mark.parametrize("site", SITES, ids=[s[0] for s in SITES])
def test_dtype_rule_at_every_call_site_is_the_reference_rule(monkeypatch, site):
    name, path, call, tiny, jax_dt = site
    with open(os.path.join(PKG, path)) as f:
        src = f.read()
    assert call in src, f"{name}: {path} no longer calls {call}"
    dt = {torch.bfloat16: "bf16", torch.float32: "fp32"}
    port = (dt[tiny_real.serving_dtype(torch.device("cuda"), tiny=tiny)],
            dt[tiny_real.serving_dtype("cpu", tiny=tiny)])
    if jax_dt == "serving":
        jax_dt = (_jax_serving_dtype(monkeypatch, "tpu"), _jax_serving_dtype(monkeypatch, "cpu"))
    elif not isinstance(jax_dt, tuple):
        jax_dt = (_jax_default(jax_dt),) * 2
    if name in FULL_WIDTH_RULE:
        assert not tiny and port == ("bf16", "fp32"), name
    else:
        assert port == jax_dt, f"{name}: the port serves {port}, the reference {jax_dt}"
    assert re.search(r"serving_dtype\([^)]*\btiny=", call)


# -- the launch counts by mode -----------------------------------------------------

def test_launch_counts_name_every_mode_and_a_path_is_held_to_its_own():
    """``ops.launch_counts`` reads each mode's own counter; ``chip_smoke``'s
    ``path_launches`` returns a path's two counts in its modes and fails a
    path that launched any other mode (a tiny-real path through a bf16
    kernel, or a full-width one through an fp32 kernel)."""
    import chip_smoke
    from infernos_tpu_torch import ops

    assert set(ops.launch_counts()) == {"attention", "attention_fp32", "bf16_step",
                                        "int8_step", "fp32_step", "int8_fp32_step",
                                        "cross_i8"}
    saved = ops.launch_counts()
    try:
        ts.fused_decode_step.launches_int8_fp32 = 5
        attn.fused_attention.launches_fp32 = 7
        assert ops.launch_counts()["int8_fp32_step"] == 5
        assert ops.launch_counts()["attention_fp32"] == 7
        ops.reset_launch_counts()
        assert set(ops.launch_counts().values()) == {0}
    finally:
        for name, (module, counter) in ops.LAUNCH_COUNTERS.items():
            setattr(ops._entry(module), counter, saved[name])
    c = dict.fromkeys(ops.LAUNCH_COUNTERS, 0)
    assert chip_smoke.path_launches({**c, "attention_fp32": 2, "fp32_step": 3}, "tiny",
                                    fp32=True) == (2, 3)
    assert chip_smoke.path_launches({**c, "attention": 32, "int8_step": 9}, "turn",
                                    fp32=False, int8=True) == (32, 9)
    for fp32, stray in ((True, "bf16_step"), (True, "attention"), (False, "fp32_step"),
                        (False, "int8_fp32_step"), (True, "cross_i8"), (False, "cross_i8")):
        with pytest.raises(RuntimeError, match="outside this path's modes"):
            chip_smoke.path_launches({**c, stray: 1}, "path", fp32=fp32)
