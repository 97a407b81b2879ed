"""The trained tiny attendant LLM on the port.

- ``tiny_real.load_tiny_llm`` gives the tree that ``from_jax_params`` makes
  of the JAX package's ``load_tiny_llm``, leaf for leaf (fp32 on the CPU).
- Served by both packages' ``LLMEngine`` (the actor's tiny-real engine
  config, 4 slots; fp32), its greedy replies over the contexts of 20 policy
  dialogues (``tools/train_tiny_llm.py``'s held-out draw) are equal.
- ``chip_smoke.py``'s expected replies (its ``llm_tiny`` phase holds the
  card to them; the script may not import the trainer, which imports JAX)
  are the trainer's policy for their contexts, and the port's replies to
  them on the CPU.
"""

import jax
import numpy as np
import pytest

import chip_smoke as cs
from infernos_tpu.models import tiny_real as jtiny
from infernos_tpu.models.tokenizers import ByteTokenizer as JByteTokenizer
from infernos_tpu.serving import llm_engine as jle
from infernos_tpu_torch.models import tiny_real as ptiny
from infernos_tpu_torch.models.convert import from_jax_params
from infernos_tpu_torch.models.tokenizers import ByteTokenizer
from infernos_tpu_torch.serving import llm_engine as ple
from tools.train_tiny_llm import SYSTEM_PROMPT, make_dialogue, policy

ECFG = dict(batch_slots=4, prompt_buckets=(128, 256, 384), max_total_tokens=448,
            max_new_tokens=64)  # the actors' tiny-real engine config


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    else:
        yield path, tree


def _replies(mod, params, cfg, contexts):
    """Each context's reply, the engine's sentences joined, in order."""
    tok = (ByteTokenizer if mod is ple else JByteTokenizer)()
    extra = {"device": "cpu"} if mod is ple else {}
    eng = mod.LLMEngine(params, cfg, mod.LLMEngineConfig(**ECFG),
                        detokenize=tok.detokenize, **extra)
    out = [[] for _ in contexts]
    for i, ctx in enumerate(contexts):
        eng.submit(mod.LLMRequest(tok(mod.apply_chat_template(ctx)),
                                  lambda s, fin, i=i: out[i].append(s)))
    while eng.step():
        pass
    return [" ".join(s for s in o if s) for o in out]


@pytest.fixture(scope="module")
def port_model():
    return ptiny.load_tiny_llm("cpu")


def test_loader_tree_matches_the_reference(port_model):
    params, cfg = port_model
    jparams, jcfg = jtiny.load_tiny_llm()
    ref = dict(_flat(from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), "cpu")))
    got = dict(_flat(params))
    assert set(got) == set(ref) and len(got) > 10
    for k, r in ref.items():
        assert got[k].dtype == r.dtype and got[k].shape == r.shape, k
        assert (got[k] == r).all(), k
    assert {f: getattr(cfg, f) for f in cfg.__dataclass_fields__} == \
        {f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__}


def test_replies_over_policy_dialogues_match_the_reference(port_model):
    rng = np.random.default_rng(10_000)
    contexts = [ctx for _ in range(20) for ctx, _ in make_dialogue(rng)]
    jparams, jcfg = jtiny.load_tiny_llm()
    ref = _replies(jle, jparams, jcfg, contexts)
    got = _replies(ple, *port_model, contexts)
    assert len(contexts) >= 20
    assert got == ref


def test_chip_smoke_expected_replies_are_the_policy(port_model):
    contexts = [ctx for ctx, _ in cs.LLM_TINY_CASES]
    for ctx, expect in cs.LLM_TINY_CASES:
        assert ctx[0] == {"role": "system", "content": SYSTEM_PROMPT}
        assert expect == policy(ctx[-1]["content"])
    assert len(set(e for _, e in cs.LLM_TINY_CASES)) >= 6
    assert _replies(ple, *port_model, contexts) == [e for _, e in cs.LLM_TINY_CASES]
