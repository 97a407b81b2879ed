"""The port's Qwen model (``infernos_tpu_torch/models/qwen.py``) against the
JAX package's on the same weights and the same seeded numpy inputs, fp32 on
the CPU: tiny random weights (``QWEN_TINY``, drawn by the JAX package and
carried across with ``from_jax_params``) and the vendored trained tiny LLM.

- ``prefill`` logits within 1e-4 of the logits' peak, K/V stacks likewise.
- 16 greedy ``decode_step`` steps from a prefilled cache: logits within the
  same tolerance at every step, equal token ids, and the cache rows written
  at each step's position equal to the JAX cache's.
- ``verify_steps`` over a 4-token window: logits and the rows written.
- ``quant.quantize_params`` of the Qwen tree: the same leaves quantized,
  codes bit-equal, scales equal.
- The port's seeded ``init_params`` makes the JAX tree's keys and shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infernos_tpu.models import presets as jpresets
from infernos_tpu.models import quant as jquant
from infernos_tpu.models import qwen as jq
from infernos_tpu.models import tiny_real as jtiny
from infernos_tpu_torch.models import presets, quant
from infernos_tpu_torch.models import qwen as pq
from infernos_tpu_torch.models import tiny_real as ptiny
from infernos_tpu_torch.models.convert import from_jax_params

TOL = 1e-4  # of the logits' peak, fp32
B, T, TMAX, STEPS = 2, 12, 48, 16


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    else:
        yield path, tree


@pytest.fixture(scope="module", params=["tiny_random", "tiny_llm"])
def model(request):
    if request.param == "tiny_random":
        cfg = jpresets.QWEN_TINY
        jparams = jq.init_params(jax.random.PRNGKey(0), cfg)
        pcfg = presets.QWEN_TINY
    else:
        jparams, cfg = jtiny.load_tiny_llm()
        pcfg = ptiny.load_tiny_llm("cpu")[1]
    assert pcfg == pq.QwenConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    return cfg, jparams, pcfg, from_jax_params(_np(jparams), "cpu")


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(3, cfg.vocab_size, shape).astype(np.int32)


def _close(a, b, peak=None):
    a, b = np.asarray(a), np.asarray(b)
    peak = np.abs(a).max() if peak is None else peak
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= TOL * peak, (np.abs(a - b).max(), peak)


def _prefilled(model):
    """Both packages' caches holding the same prefill of ``T`` tokens."""
    cfg, jparams, pcfg, pparams = model
    toks = _tokens(cfg, (B, T), 1)
    _, ks, vs = jq.prefill(jparams, cfg, jnp.asarray(toks))
    jc = jq.init_cache(cfg, B, TMAX)
    jc = jq.QwenCache(jc.k.at[:, :, :, :T].set(ks), jc.v.at[:, :, :, :T].set(vs))
    pc = pq.init_cache(pcfg, B, TMAX)
    pc.k[:, :, :, :T] = torch.from_numpy(np.array(ks))
    pc.v[:, :, :, :T] = torch.from_numpy(np.array(vs))
    return jc, pc


def test_prefill_matches_the_reference(model):
    cfg, jparams, pcfg, pparams = model
    toks = _tokens(cfg, (B, T), 0)
    off = np.array([0, 5], np.int32)
    jl, jk, jv = jq.prefill(jparams, cfg, jnp.asarray(toks), jnp.asarray(off))
    with torch.no_grad():
        pl, pk, pv = pq.prefill(pparams, pcfg, torch.from_numpy(toks).long(),
                                torch.from_numpy(off).long())
    _close(jl, pl.numpy())
    _close(jk, pk.numpy())
    _close(jv, pv.numpy())


def test_greedy_decode_matches_the_reference(model):
    cfg, jparams, pcfg, pparams = model
    jc, pc = _prefilled(model)
    pos = np.array([T, T - 3], np.int32)  # slots at different positions
    tok = _tokens(cfg, (B,), 2)
    for step in range(STEPS):
        jl, jc = jq.decode_step(jparams, cfg, jnp.asarray(tok), jc, jnp.asarray(pos))
        with torch.no_grad():
            pl, pc = pq.decode_step(pparams, pcfg, torch.from_numpy(tok).long(), pc,
                                    torch.from_numpy(pos).long())
        _close(jl, pl.numpy())
        ids = np.asarray(jl).argmax(-1)
        assert (pl.numpy().argmax(-1) == ids).all(), f"step {step}"
        for b in range(B):  # the rows written at this step's positions
            for jcache, pcache in ((jc.k, pc.k), (jc.v, pc.v)):
                _close(np.asarray(jcache)[:, b, :, pos[b]], pcache[:, b, :, pos[b]].numpy())
        tok, pos = ids.astype(np.int32), pos + 1
    _close(jc.k, pc.k.numpy())
    _close(jc.v, pc.v.numpy())


def test_verify_steps_matches_the_reference(model):
    cfg, jparams, pcfg, pparams = model
    jc, pc = _prefilled(model)
    pos = np.array([T, T - 3], np.int32)
    toks = _tokens(cfg, (B, 4), 3)
    jl, jc = jq.verify_steps(jparams, cfg, jnp.asarray(toks), jc, jnp.asarray(pos))
    with torch.no_grad():
        pl, pc = pq.verify_steps(pparams, pcfg, torch.from_numpy(toks).long(), pc,
                                 torch.from_numpy(pos).long())
    _close(jl, pl.numpy())
    assert (np.asarray(jl).argmax(-1) == pl.numpy().argmax(-1)).all()
    _close(jc.k, pc.k.numpy())
    _close(jc.v, pc.v.numpy())


def test_int8_tree_matches_the_reference(model):
    cfg, jparams, pcfg, pparams = model
    ref = dict(_flat(_np(jquant.quantize_params(jparams))))
    got = dict(_flat(quant.quantize_params(pparams)))
    assert set(got) == set(ref)
    assert any(k[-1] == "w_q" for k in got)
    for k, r in ref.items():
        g = got[k].numpy()
        assert g.dtype == r.dtype and g.shape == r.shape, k
        assert (g == r).all(), k  # codes bit-equal, scales equal


def test_seeded_init_makes_the_reference_tree():
    cfg = jpresets.QWEN_TINY
    ref = dict(_flat(_np(jq.init_params(jax.random.PRNGKey(0), cfg))))
    got = dict(_flat(pq.init_params(presets.QWEN_TINY, torch.Generator().manual_seed(0),
                                    "cpu")))
    assert set(got) == set(ref)
    for k, r in ref.items():
        assert tuple(got[k].shape) == r.shape and got[k].dtype == torch.float32, k
    assert torch.equal(got[("ln_f", "g")], torch.ones(cfg.hidden_size))
