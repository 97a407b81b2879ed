"""The port's sharding specs and memory budget against the JAX package.

- ``qwen.param_shardings``, ``qwen.cache_shardings`` and
  ``quant.quantize_shardings`` equal the JAX package's spec for spec (as
  tuples) for Qwen2.5-14B, Qwen2.5-7B, the tiny config and a tied one;
- ``parallel.budget``'s ``per_chip_bytes``, ``replicated_bytes`` and
  ``budget_report`` equal JAX's, byte for byte, on the 14B int8 trees at tp
  1, 2 and 4 (the port's shape trees are ``meta`` tensors);
- port copies of the three budget tests of ``tests/test_qwen14b_budget.py``
  (the abstract lowering becomes a rank-local tp-4 decode step on ``meta``
  tensors at real 14B dims: output shapes checked, no weight materialised);
- the H100 finding: int8 14B with its KV cache fits one 80 GB card at tp 1;
- ``parallel.mesh.shard`` cuts each rank's block where JAX's
  ``NamedSharding`` puts it, uneven shards included, and
  ``shard_tts_state`` slices the slot axis of a ``TTSState``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from infernos_tpu.models import qwen as jq
from infernos_tpu.models.quant import quantize_params as jquantize_params
from infernos_tpu.models.quant import quantize_shardings as jquantize_shardings
from infernos_tpu.parallel import budget as jbudget
from infernos_tpu.parallel import make_mesh as jmake_mesh
from infernos_tpu_torch.models import presets, qwen
from infernos_tpu_torch.models.quant import quantize_params, quantize_shardings
from infernos_tpu_torch.parallel import budget, shard_tts_state
from infernos_tpu_torch.parallel.mesh import P, Mesh, shard, tree_map

SLOTS = 8           # reference batch, Cluster/InfernLLMWorker.py
MAX_TOTAL = 2048    # engine default max_total_tokens
MAX_BUCKET = 1024   # largest prefill bucket
H100_BYTES = 80 * 10**9  # one H100's memory, NVIDIA's data sheet (80 GB)

TIED = dataclasses.replace(presets.QWEN_TINY, tie_word_embeddings=True)
CFGS = {"14b": presets.QWEN25_14B, "7b": presets.QWEN25_7B,
        "tiny": presets.QWEN_TINY, "tied": TIED}


def _jcfg(cfg):
    return jq.QwenConfig(**dataclasses.asdict(cfg))


def _flat(tree, path=""):
    """Spec tree -> {path: tuple(spec) or None}; a spec (either package's,
    both tuples) is a leaf."""
    if tree is None or isinstance(tree, (JP, P)):
        return {path: None if tree is None else tuple(tree)}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}"))
        return out
    if hasattr(tree, "_fields"):
        return _flat(dict(zip(tree._fields, tree)), path)
    out = {}
    for i, v in enumerate(tree):
        out.update(_flat(v, f"{path}/{i}"))
    return out


def _port_shapes(cfg, dtype=torch.bfloat16):
    """The port's serving weight layout on ``meta``: int8 linears, bf16 dense."""
    return quantize_params(qwen.init_params(cfg, None, "meta", dtype))


def _jax_shapes(cfg):
    def build(key):
        p = jq.init_params(key, _jcfg(cfg))
        p = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), p)
        return jquantize_params(p)

    return jax.eval_shape(build, jax.random.PRNGKey(0))


@pytest.mark.parametrize("name", sorted(CFGS))
def test_param_and_cache_specs_equal_jax(name):
    cfg = CFGS[name]
    assert _flat(qwen.param_shardings(cfg)) == _flat(jq.param_shardings(_jcfg(cfg)))
    assert _flat(qwen.param_shardings(cfg, "x")) == _flat(jq.param_shardings(_jcfg(cfg), "x"))
    assert _flat(qwen.cache_shardings(cfg)) == _flat(jq.cache_shardings(_jcfg(cfg)))
    assert ("lm_head" in qwen.param_shardings(cfg)) == (not cfg.tie_word_embeddings)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_quantize_specs_equal_jax(name):
    cfg = CFGS[name]
    # the tiny configs quantize nothing at the default size floor: use a
    # floor that quantizes their linears, as the JAX int8 TP test does
    floor = 4096 if name in ("14b", "7b") else 256
    got = quantize_shardings(qwen.param_shardings(cfg),
                             quantize_params(qwen.init_params(cfg, None, "meta"), floor))
    jshapes = jax.eval_shape(lambda k: jquantize_params(jq.init_params(k, _jcfg(cfg)), floor),
                             jax.random.PRNGKey(0))
    want = jquantize_shardings(jq.param_shardings(_jcfg(cfg)), jshapes)
    assert _flat(got) == _flat(want)
    assert any("w_q" in k for k in _flat(got))


@pytest.fixture(scope="module")
def trees_14b():
    cfg = presets.QWEN25_14B
    pshapes, jshapes = _port_shapes(cfg), _jax_shapes(cfg)
    pspecs = quantize_shardings(qwen.param_shardings(cfg), pshapes)
    jspecs = jquantize_shardings(jq.param_shardings(_jcfg(cfg)), jshapes)
    return pshapes, pspecs, jshapes, jspecs


def _parts(tp, port):
    """The budget test's parts at tp ``tp`` by the port's accounting or JAX's."""
    cfg = presets.QWEN25_14B
    axis = {"tp": tp}
    if port:
        pc = budget.per_chip_bytes
        kv = pc(qwen.init_cache(cfg, SLOTS, MAX_TOTAL, torch.bfloat16, "meta"),
                qwen.cache_shardings(cfg), axis)
        pre = pc(qwen.init_cache(cfg, 1, MAX_BUCKET, torch.bfloat16, "meta"),
                 qwen.cache_shardings(cfg), axis)
    else:
        jc = _jcfg(cfg)
        pc = jbudget.per_chip_bytes
        kv = pc(jax.eval_shape(lambda: jq.init_cache(jc, SLOTS, MAX_TOTAL, dtype=jnp.bfloat16)),
                jq.cache_shardings(jc), axis)
        pre = pc(jax.eval_shape(lambda: jq.init_cache(jc, 1, MAX_BUCKET, dtype=jnp.bfloat16)),
                 jq.cache_shardings(jc), axis)
    return {"kv_cache_bf16": kv, "prefill_kv_bf16": pre,
            "prefill_act_bf16": MAX_BUCKET * cfg.hidden_size * 2 * 4}


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_budget_bytes_equal_jax(trees_14b, tp):
    pshapes, pspecs, jshapes, jspecs = trees_14b
    got = budget.per_chip_bytes(pshapes, pspecs, {"tp": tp})
    assert got == jbudget.per_chip_bytes(jshapes, jspecs, {"tp": tp})
    assert budget.replicated_bytes(pshapes) == jbudget.replicated_bytes(jshapes)
    parts, jparts = _parts(tp, True), _parts(tp, False)
    assert parts == jparts
    parts["weights_int8"] = got
    jparts["weights_int8"] = got
    assert budget.budget_report(parts) == jbudget.budget_report(jparts)
    assert budget.V5E_HBM_BYTES == jbudget.V5E_HBM_BYTES


def test_budget_spec_tree_mismatch_raises(trees_14b):
    pshapes, pspecs, _, _ = trees_14b
    with pytest.raises(ValueError):
        budget.per_chip_bytes(pshapes, qwen.param_shardings(presets.QWEN25_14B), {"tp": 4})


def test_14b_int8_tp4_fits_v5e_hbm(trees_14b):
    """Port copy: int8 14B weights + bf16 KV (8 slots x 2048) + prefill
    buffers fit a v5e chip under ``param_shardings`` at tp 4, with 10%
    headroom."""
    pshapes, pspecs, _, _ = trees_14b
    parts = {"weights_int8": budget.per_chip_bytes(pshapes, pspecs, {"tp": 4}),
             **_parts(4, True)}
    rep = budget.budget_report(parts, limit=budget.V5E_HBM_BYTES, headroom=0.10)
    assert rep["fits"], rep
    w_gib = parts["weights_int8"] / 1024**3
    assert 2.5 < w_gib < 7.0, f"weights/chip {w_gib:.2f} GiB implausible"


def test_14b_does_not_fit_one_chip(trees_14b):
    """Port copy of the negative control: the same accounting does not fit
    one v5e chip unsharded."""
    pshapes = trees_14b[0]
    parts = {"weights_int8": budget.replicated_bytes(pshapes),
             "kv_cache_bf16": budget.replicated_bytes(qwen.init_cache(
                 presets.QWEN25_14B, SLOTS, MAX_TOTAL, torch.bfloat16, "meta"))}
    rep = budget.budget_report(parts, limit=budget.V5E_HBM_BYTES, headroom=0.10)
    assert not rep["fits"], rep


def test_14b_int8_fits_one_h100_at_tp1(trees_14b):
    """The H100 finding: int8 14B (15.2 GiB) with its bf16 KV cache (8
    slots x 2048, 3.0 GiB) and prefill buffers fits one 80 GB card
    unsharded, with 10% headroom; bf16 weights (27.5 GiB) fit too."""
    pshapes, pspecs = trees_14b[:2]
    parts = {"weights_int8": budget.per_chip_bytes(pshapes, pspecs, {"tp": 1}),
             **_parts(1, True)}
    rep = budget.budget_report(parts, limit=H100_BYTES, headroom=0.10)
    assert rep["fits"], rep
    assert rep["parts_gib"]["weights_int8"] == pytest.approx(15.215, abs=1e-3)
    assert rep["parts_gib"]["kv_cache_bf16"] == pytest.approx(3.0, abs=1e-3)
    dense = budget.replicated_bytes(qwen.init_params(presets.QWEN25_14B, None, "meta",
                                                     torch.bfloat16))
    assert dense / 1024**3 == pytest.approx(27.511, abs=1e-3)
    assert budget.budget_report({"w": dense, **_parts(1, True)}, limit=H100_BYTES)["fits"]


@pytest.mark.parametrize("rank", [0, 3])
def test_14b_tp4_decode_step_on_meta(trees_14b, rank):
    """Port of the abstract lowering: one rank's tp-4 decode step at real
    14B dims on ``meta`` tensors (its int8 shards, its cache of 2 KV heads)
    gives whole-vocab logits and keeps the cache's shape; nothing is
    materialised."""
    cfg = presets.QWEN25_14B
    pshapes, pspecs = trees_14b[:2]
    mesh = Mesh(("tp",), (4,), (rank,), torch.device("meta"))
    params = shard(pshapes, pspecs, mesh)
    assert params["layers"]["q"]["w_q"].shape == (48, 5120, 1280)
    assert params["layers"]["o"]["w_q"].shape == (48, 1280, 5120)
    assert params["layers"]["o"]["scale"].shape == (48, 5120)
    assert params["lm_head"]["w"].shape == (5120, 152064 // 4)
    cache = shard(qwen.init_cache(cfg, SLOTS, MAX_TOTAL, torch.bfloat16, "meta"),
                  qwen.cache_shardings(cfg), mesh)
    assert cache.k.shape == (48, SLOTS, 2, MAX_TOTAL, 128)
    tok = torch.zeros(SLOTS, dtype=torch.long, device="meta")
    logits, cache2 = qwen.decode_step(params, cfg, tok, cache, tok, mesh=mesh)
    assert logits.is_meta and logits.shape == (SLOTS, cfg.vocab_size)
    assert logits.argmax(-1).shape == (SLOTS,)
    assert cache2.k.shape == cache.k.shape
    leaves = []
    tree_map(leaves.append, (params, cache2))
    assert len(leaves) > 10 and all(t.is_meta for t in leaves)


def test_heads_must_divide_over_tp():
    mesh = Mesh(("tp",), (3,), (0,), torch.device("meta"))
    with pytest.raises(ValueError, match="do not divide"):
        qwen.shard_config(presets.QWEN25_14B, mesh)


@pytest.mark.parametrize("shape,spec", [
    ((8, 12), (None, "x")), ((12, 3), ("x",)), ((2, 8, 5), (None, "x", None)),
    ((8,), ("x",))])
def test_shard_blocks_where_jax_puts_them(shape, spec):
    """Each rank's block equals the data of JAX's shard for its device on
    a 4-device mesh."""
    x = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
    jm = jmake_mesh(4, axes=("x",))
    jx = jax.device_put(jnp.asarray(x), NamedSharding(jm, JP(*spec)))
    devs = list(jm.devices.flat)
    for r in range(4):
        mesh = Mesh(("x",), (4,), (r,), torch.device("cpu"))
        got = shard({"a": torch.from_numpy(x)}, {"a": P(*spec)}, mesh)["a"]
        want = next(s for s in jx.addressable_shards if s.device == devs[r])
        np.testing.assert_array_equal(got.numpy(), np.asarray(x[want.index]))


def test_uneven_shards_are_ceil_blocks():
    """10 over 4 ranks: blocks of ceil(10 / 4) = 3 in rank order, the last
    short (XLA's padded layout; ``jax.device_put`` refuses uneven shards),
    and the budget counts the full block on every rank."""
    x = torch.arange(10.0)
    got = [shard(x, P("x"), Mesh(("x",), (4,), (r,), torch.device("cpu"))) for r in range(4)]
    assert [t.tolist() for t in got] == [[0, 1, 2], [3, 4, 5], [6, 7, 8], [9]]
    assert budget.per_chip_bytes(x, P("x"), {"x": 4}) == 3 * 4
    assert jbudget.per_chip_bytes(jnp.zeros(10), JP("x"), {"x": 4}) == 3 * 4


def test_shard_tts_state_slices_slots():
    from infernos_tpu_torch.models import speecht5 as st5
    from infernos_tpu_torch.serving.tts_engine import TTSState

    cfg = presets.SPEECHT5_TINY
    B = 4
    g = torch.Generator().manual_seed(0)
    z = lambda *s, dtype=torch.float32: torch.randn(s, generator=g).to(dtype)
    cache = st5.init_cache(cfg, B, 8, 6, "cpu")
    for name in ("self_k", "self_v", "cross_k", "cross_v"):
        getattr(cache, name).normal_(generator=g)
    state = TTSState(cache=cache, enc_mask=z(B, 6) > 0, spk=z(B, 16), prev_mel=z(B, 1, 20),
                     pos=torch.arange(B), stopped=z(B) > 0, active=z(B) > 0,
                     mel_ctx=z(B, 4, 20))
    for r in range(2):
        mesh = Mesh(("dp",), (2,), (r,), torch.device("cpu"))
        got = shard_tts_state(state, mesh)
        sl = slice(2 * r, 2 * r + 2)
        assert torch.equal(got.cache.self_k, cache.self_k[:, sl])
        assert torch.equal(got.cache.cross_v, cache.cross_v[:, sl])
        for name in ("enc_mask", "spk", "prev_mel", "pos", "stopped", "active", "mel_ctx"):
            assert torch.equal(getattr(got, name), getattr(state, name)[sl]), name
