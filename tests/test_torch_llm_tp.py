"""The port's LLM tensor parallelism on gloo groups of CPU rank processes.

Port copies of ``tests/test_llm_tp.py`` (the engine under tp against the
unsharded engine, a queued join under tp, the 14B preset's dims; also
speculative decode under tp), of
``tests/test_qwen14b_budget.py``'s ``test_tiny_tp_engine_int8_matches_dense``
and of ``tests/test_qwen_parity.py``'s sharded prefill (on a seeded tree at
that test's HF dims; the parity with HF itself is
``test_torch_qwen_parity.py``'s), at tp 2 and tp 4 (``parallel.ranks.run_ranks``,
file rendezvous, 60 s group timeout; the two groups run at once).  The JAX
package's weights go to the ranks as numpy trees; the rank functions live
in ``torch_rank_fns.py``, which imports no ``jax``.  Tokens must equal the
port's unsharded engine's and the JAX engine's (and, for the dense tree,
the JAX engine's on its 8-way virtual mesh); prefill logits agree within
``atol=1e-4`` (the JAX test's tolerance).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding

from infernos_tpu.models import qwen as jq
from infernos_tpu.models.quant import quantize_params as jquantize_params
from infernos_tpu.parallel import make_mesh as jmake_mesh
from infernos_tpu.serving import llm_engine as jle
from infernos_tpu_torch.models import presets, qwen
from infernos_tpu_torch.models.convert import from_numpy
from infernos_tpu_torch.models.quant import quantize_params
from infernos_tpu_torch.parallel.ranks import run_ranks
from infernos_tpu_torch.serving.llm_engine import LLMEngine, LLMEngineConfig

import torch_rank_fns as rf

# GQA config whose kv heads split over the meshes (tests/test_llm_tp.py)
TP_CFG = qwen.QwenConfig(
    vocab_size=160, hidden_size=64, num_layers=2, num_heads=8,
    num_kv_heads=8, head_dim=8, intermediate_size=128, rope_theta=10000.0,
    max_positions=256, eos_token_id=2, tie_word_embeddings=False,
)
JTP_CFG = jq.QwenConfig(**{f: getattr(TP_CFG, f) for f in TP_CFG.__dataclass_fields__})
ECFG = dict(batch_slots=2, prompt_buckets=(16,), max_total_tokens=48, max_new_tokens=8)
INT8_PROMPT = list(range(3, 12))
INT8_FLOOR = 256


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jcollect(engine, prompts):
    outs = {i: [] for i in range(len(prompts))}
    for i, p in enumerate(prompts):
        engine.submit(jle.LLMRequest(np.asarray(p, np.int32),
                                     lambda s, f, i=i: outs[i].append((s, f))))
    while engine.step():
        pass
    return outs


def _jplace(tree, specs, mesh):
    return jax.tree_util.tree_map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
                                  tree, specs, is_leaf=lambda x: isinstance(x, jnp.ndarray))


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(3, 150, size=n).tolist() for n in (5, 9, 14)]


@pytest.fixture(scope="module")
def jparams():
    return jq.init_params(jax.random.PRNGKey(1), JTP_CFG)


@pytest.fixture(scope="module")
def hf():
    """The JAX package's seeded tree at ``tests/test_qwen_parity.py``'s HF
    Qwen2 dims (4 heads, 2 KV heads), and its tokens."""
    cfg = qwen.QwenConfig(vocab_size=120, hidden_size=32, num_layers=2, num_heads=4,
                          num_kv_heads=2, head_dim=8, intermediate_size=64,
                          rope_theta=10000.0, max_positions=128, eos_token_id=2)
    jcfg = jq.QwenConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, size=(2, 6))
    return jq.init_params(jax.random.PRNGKey(7), jcfg), jcfg, cfg, toks


@pytest.fixture(scope="module")
def groups(jparams, prompts, hf):
    """Every case of this file on a group of 2 ranks and on one of 4 (the
    prefill case at tp 2 only: its config has 2 KV heads).  Both groups
    start at once, in the background: the references below are computed
    while the ranks run, and a test waits for its group's results."""
    from concurrent.futures import ThreadPoolExecutor

    def run(tp):
        hf_arg = (_np(hf[0]), hf[2], hf[3]) if tp == 2 else None
        return run_ranks(rf.tp_suite, tp,
                         (_np(jparams), TP_CFG, prompts, INT8_PROMPT, INT8_FLOOR, hf_arg),
                         device="cpu")

    with ThreadPoolExecutor(2) as ex:
        yield {tp: ex.submit(run, tp) for tp in (2, 4)}


@pytest.fixture(params=[2, 4], ids=lambda t: f"tp{t}")
def suite(request, groups):
    """``(tp, future of the group's results)``."""
    return request.param, groups[request.param]


@pytest.fixture(scope="module")
def want(jparams, prompts):
    """The three prompts through the port's unsharded engine, the JAX
    engine and the JAX engine on its 8-way mesh."""
    port = rf.collect(LLMEngine(_port_params(jparams), TP_CFG, LLMEngineConfig(**ECFG),
                                device="cpu"), prompts)
    ecfg = jle.LLMEngineConfig(**ECFG)
    jwant = _jcollect(jle.LLMEngine(jparams, JTP_CFG, ecfg), prompts)
    mesh = jmake_mesh(8, axes=("tp",))
    jmesh = _jcollect(jle.LLMEngine(_jplace(jparams, jq.param_shardings(JTP_CFG), mesh),
                                    JTP_CFG, ecfg, mesh=mesh), prompts)
    return port, jwant, jmesh


@pytest.fixture(scope="module")
def want_int8(jparams):
    """The int8 prompt through the unsharded port and JAX engines on the
    int8 tree (the JAX package's own test holds its 8-way mesh to its
    unsharded engine on this tree)."""
    ecfg = LLMEngineConfig(**ECFG)
    port = rf.collect(LLMEngine(quantize_params(_port_params(jparams), INT8_FLOOR),
                                TP_CFG, ecfg, device="cpu"), [INT8_PROMPT])[0]
    jq8 = jquantize_params(jparams, min_size=INT8_FLOOR)
    jwant = _jcollect(jle.LLMEngine(jq8, JTP_CFG, jle.LLMEngineConfig(**ECFG)),
                      [INT8_PROMPT])[0]
    return port, jwant


def _port_params(jparams):
    return from_numpy(_np(jparams), "cpu")


def test_engine_tp_matches_unsharded(suite, want):
    tp, res = suite[0], suite[1].result()
    port, jwant, jmesh = want
    assert port == jwant == jmesh
    for r in res:  # every rank streams the same sentences
        assert r["matches"] == port
        # the cache holds this rank's kv heads
        assert r["cache"] == (2, 2, TP_CFG.num_kv_heads // tp, 48, 8)


def test_engine_tp_queued_join(suite, prompts):
    """Continuous batching under tp: a queued request joins a freed slot."""
    res = suite[1].result()
    for r in res:
        assert r["queued"][1] == r["direct"]


def test_tiny_tp_engine_int8_matches_dense(suite, want_int8):
    """The tp engine on the int8 tree (quantized whole, then sharded with
    ``quantize_shardings``) decodes what the unsharded engine decodes on the
    same int8 tree, in the port and in the JAX package."""
    res = suite[1].result()
    port, jwant = want_int8
    assert port == jwant
    for r in res:
        assert r["int8"] == port


def test_engine_tp_spec_decode_matches_unsharded(suite, jparams, prompts):
    """Speculative decode (n-gram drafts verified by ``qwen.verify_steps``)
    under tp streams what the port's unsharded engine streams (whose spec
    decode ``test_torch_llm_engine.py`` holds to the JAX engine's)."""
    res = suite[1].result()
    ecfg = dict(ECFG, spec_decode=True, spec_k=4)
    port = rf.collect(LLMEngine(_port_params(jparams), TP_CFG, LLMEngineConfig(**ecfg),
                                device="cpu"), prompts)
    for r in res:
        assert r["spec"] == port


def test_tp_sharded_prefill_matches(groups, hf):
    """tp over rank processes is numerically transparent: prefill logits
    of the group of 2 within 1e-4 of the unsharded JAX and port prefill,
    and of JAX's on a 2-device mesh."""
    res = groups[2].result()
    jparams, jcfg, cfg, toks = hf
    want = np.asarray(jq.prefill(jparams, jcfg, jnp.asarray(toks))[0])
    mesh = jmake_mesh(2, axes=("tp",))
    jtp = np.asarray(jax.jit(lambda p, t: jq.prefill(p, jcfg, t))(
        _jplace(jparams, jq.param_shardings(jcfg), mesh), jnp.asarray(toks))[0])
    port = qwen.prefill(from_numpy(_np(jparams), "cpu"), cfg, torch.from_numpy(toks))[0]
    for r in res:
        np.testing.assert_allclose(r["prefill"], want, atol=1e-4)
        np.testing.assert_allclose(r["prefill"], jtp, atol=1e-4)
        np.testing.assert_allclose(r["prefill"], port.numpy(), atol=1e-4)


def test_14b_preset_dims():
    """The preset is the real Qwen2.5-14B geometry; its heads divide tp 2
    and 4, the groups of these tests."""
    c = presets.QWEN25_14B
    assert (c.hidden_size, c.num_layers, c.num_heads, c.num_kv_heads) == (5120, 48, 40, 8)
    assert c.intermediate_size == 13824 and c.vocab_size == 152064
    for t in (2, 4):
        assert c.num_heads % t == 0 and c.num_kv_heads % t == 0
