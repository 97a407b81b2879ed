"""The port's LLM engine (``infernos_tpu_torch/serving/llm_engine.py``):
the ten tests of ``tests/test_llm_engine.py`` (continuous batching,
sentence streaming, K steps per dispatch, speculative decode) on the port,
fp32 on the CPU, on the JAX package's seeded tiny weights (carried across
with ``from_jax_params``) -- and the engine's token ids against the JAX
engine's for the same requests with K 1 and 4, with ``spec_decode`` and
with ``max_inflight`` 2 (requests of three lengths over two slots, one
queued behind them; 40 new tokens each, random weights emit no EOS).
Also ``chip_smoke.py`` phase ``llm``'s batching check at tiny dims: the
full start's int8 tree with its layers seeded (``seeded_layers``), on the
full actor's engine, must give each request the same token ids in a batch
as alone, and these must depend on the prompt.
"""

import dataclasses

import jax
import numpy as np
import pytest

from infernos_tpu.models import qwen as jq
from infernos_tpu.serving import llm_engine as jle
from infernos_tpu_torch.models import qwen
from infernos_tpu_torch.models.convert import from_jax_params
from infernos_tpu_torch.serving import llm_engine as ple
from infernos_tpu_torch.serving.llm_engine import (
    LLMEngine,
    LLMEngineConfig,
    LLMRequest,
    _SentenceStreamer,
    apply_chat_template,
)
from infernos_tpu_torch.serving.sessions import LLMSession

TINY = qwen.QwenConfig(
    vocab_size=120,
    hidden_size=32,
    num_layers=2,
    num_heads=4,
    num_kv_heads=2,
    head_dim=8,
    intermediate_size=64,
    rope_theta=10000.0,
    max_positions=256,
    eos_token_id=2,
    tie_word_embeddings=False,
)
JTINY = jq.QwenConfig(**{f: getattr(TINY, f) for f in TINY.__dataclass_fields__})


def _reference_params(seed):
    """The JAX package's ``init_params`` draw, as the port's tensors."""
    return from_jax_params(jax.tree_util.tree_map(
        np.asarray, jq.init_params(jax.random.PRNGKey(seed), JTINY)), "cpu")


def _detok(tokens):
    # toy detokenizer: token 50 ends a sentence, others are words
    return "".join("." if t == 50 else f" w{t}" for t in tokens)


@pytest.fixture(scope="module")
def engine():
    params = _reference_params(0)
    ecfg = LLMEngineConfig(batch_slots=3, prompt_buckets=(16, 32),
                           max_total_tokens=64, max_new_tokens=10)
    eng = LLMEngine(params, TINY, ecfg, detokenize=_detok, device="cpu")
    eng.warmup()
    return eng


def test_generation_runs_and_finishes(engine):
    outs = []
    engine.submit(LLMRequest(
        prompt_ids=np.arange(3, 10, dtype=np.int32),
        sentence_cb=lambda s, fin: outs.append((s, fin)),
    ))
    while engine.step():
        pass
    assert outs and outs[-1][1] is True
    assert engine.n_active == 0


def test_concurrent_requests_interleave(engine):
    got = {1: [], 2: []}
    engine.submit(LLMRequest(np.arange(3, 8, dtype=np.int32),
                             lambda s, f: got[1].append(f)))
    engine.submit(LLMRequest(np.arange(20, 30, dtype=np.int32),
                             lambda s, f: got[2].append(f)))
    engine.step()  # submits are deferred; the first step joins them
    assert engine.n_active == 2
    while engine.step():
        pass
    assert got[1] and got[1][-1] is True
    assert got[2] and got[2][-1] is True


def test_determinism(engine):
    a, b = [], []
    p = np.arange(40, 47, dtype=np.int32)
    engine.submit(LLMRequest(p.copy(), lambda s, f: a.append(s)))
    while engine.step():
        pass
    engine.submit(LLMRequest(p.copy(), lambda s, f: b.append(s)))
    while engine.step():
        pass
    assert a == b


def test_sentence_streamer_flush_semantics():
    flushed = []
    st = _SentenceStreamer(_detok, lambda s, fin: flushed.append((s, fin)))
    # words until a period arrives past the 10-char minimum
    for t in [11, 12, 13, 50]:
        st.push(t)
    assert len(flushed) == 1
    assert flushed[0][0].endswith(".") and flushed[0][1] is False
    st.push(14)
    st.finish()
    assert flushed[-1][1] is True


def test_chat_template():
    msgs = [{"role": "system", "content": "be brief"},
            {"role": "user", "content": "hi"}]
    s = apply_chat_template(msgs)
    assert s == ("<|im_start|>system\nbe brief<|im_end|>\n"
                 "<|im_start|>user\nhi<|im_end|>\n<|im_start|>assistant\n")


def test_llm_session_context_merge(engine):
    tokenize = lambda s: (np.frombuffer(s.encode(), np.uint8)[:24] % 100).astype(np.int32)
    sess = LLMSession(engine, tokenize, system_prompt="sys")
    sess.context_add("a", role="user")
    sess.context_add("b", role="user")  # same role: merged
    assert len(sess.context) == 2
    assert sess.context[1]["content"] == "a\nb"

    finals = []
    sess.textin("hello", lambda r: finals.append(r) if r.is_final else None)
    while engine.step():
        pass
    assert finals and finals[0].is_final
    # assistant turn auto-appended
    assert sess.context[-1]["role"] in ("assistant", "user")


def test_queued_request_joins_freed_slot_and_matches_direct_run(engine):
    """Regression: a request dequeued from _pending into a just-freed slot
    must decode identically to the same prompt run directly (the old
    _harvest rebuilt ``done`` after the join and froze the new session,
    which then streamed one repeated token until the budget)."""
    p_a = np.arange(3, 8, dtype=np.int32)
    p_b = np.arange(60, 70, dtype=np.int32)

    direct = []
    engine.submit(LLMRequest(p_b.copy(), lambda s, f: direct.append(s)))
    while engine.step():
        pass

    # fill every slot, then queue p_b behind them
    sink = lambda s, f: None
    for _ in range(engine.ecfg.batch_slots):
        engine.submit(LLMRequest(p_a.copy(), sink))
    queued = []
    engine.submit(LLMRequest(p_b.copy(), lambda s, f: queued.append(s)))
    while engine.step():
        pass
    assert engine.n_active == 0
    assert queued == direct


def test_multi_step_dispatch_matches_single():
    """K decode steps per dispatch: same tokens, same sentence stream."""
    import dataclasses as dc

    params = _reference_params(0)
    base = LLMEngineConfig(batch_slots=2, prompt_buckets=(16,),
                           max_total_tokens=48, max_new_tokens=12)

    def run(ecfg):
        eng = LLMEngine(params, TINY, ecfg, detokenize=_detok, device="cpu")
        outs = []
        eng.submit(LLMRequest(prompt_ids=np.arange(3, 11, dtype=np.int32),
                              sentence_cb=lambda s, f: outs.append((s, f))))
        eng.submit(LLMRequest(prompt_ids=np.arange(20, 25, dtype=np.int32),
                              sentence_cb=lambda s, f: outs.append((s, f))))
        while eng.step():
            pass
        return outs

    o1 = run(base)
    o4 = run(dc.replace(base, steps_per_dispatch=4))
    assert o1 == o4, (o1, o4)


def test_spec_decode_matches_plain_greedy():
    """Speculative decode must emit EXACTLY the plain greedy token stream
    (VERDICT r2 item 4; n-gram drafting only changes the step count)."""
    params = _reference_params(3)

    def run(spec):
        ecfg = LLMEngineConfig(batch_slots=2, prompt_buckets=(16,),
                               max_total_tokens=96, max_new_tokens=40,
                               steps_per_dispatch=4, spec_decode=spec,
                               spec_k=5, spec_ngram=3)
        eng = LLMEngine(params, TINY, ecfg, detokenize=_detok, device="cpu")
        outs = {}

        def mk(i):
            return lambda s, fin: outs.setdefault(i, []).append((s, fin))

        toks = {}
        for i, seed in enumerate((0, 7)):
            ids = np.asarray(
                np.random.default_rng(seed).integers(3, 100, size=9),
                np.int32)
            eng.submit(LLMRequest(prompt_ids=ids, sentence_cb=mk(i)))
        # capture emitted tokens via the streamers
        slots = [s for s in eng.slots if s is not None]
        steps = 0
        while eng.step() and steps < 400:
            steps += 1
        for i, s in enumerate(slots):
            toks[i] = list(s.streamer.tokens)
        return toks, steps

    plain, steps_plain = run(False)
    spec, steps_spec = run(True)
    assert spec == plain, (spec, plain)


def test_spec_decode_accepts_on_repetition():
    """Untrained models loop; n-gram drafting must then accept >1
    token/dispatch on average (the bandwidth win exists)."""
    from infernos_tpu_torch.utils.metrics import metrics as _m

    params = _reference_params(5)
    ecfg = LLMEngineConfig(batch_slots=1, prompt_buckets=(16,),
                           max_total_tokens=128, max_new_tokens=64,
                           spec_decode=True, spec_k=6)
    eng = LLMEngine(params, TINY, ecfg, detokenize=_detok, device="cpu")
    eng.submit(LLMRequest(prompt_ids=np.arange(3, 12, dtype=np.int32),
                          sentence_cb=lambda s, fin: None))
    before = _m.hists.get("llm.spec_emit")
    n0 = before.count if before else 0
    while eng.step():
        pass
    h = _m.hists["llm.spec_emit"]
    emitted = h.total  # includes other tests' counts; mean is what matters
    assert h.count > n0
    assert h.mean > 1.0, f"mean accepted/dispatch {h.mean}"


def _token_streams(mod, params, cfg, **kw):
    """Every request's emitted token ids, in join order, from ``mod``'s
    engine stepped to the end."""
    ecfg = mod.LLMEngineConfig(batch_slots=2, prompt_buckets=(16, 32),
                               max_total_tokens=96, max_new_tokens=40, **kw)
    extra = {"device": "cpu"} if mod is ple else {}
    eng = mod.LLMEngine(params, cfg, ecfg, detokenize=_detok, **extra)
    for seed, n in ((0, 9), (7, 14), (9, 19)):
        ids = np.random.default_rng(seed).integers(3, 100, size=n).astype(np.int32)
        eng.submit(mod.LLMRequest(prompt_ids=ids, sentence_cb=lambda s, f: None))
    seen = {}
    while True:
        for s in eng.slots:
            if s is not None:
                seen.setdefault(id(s), s)
        if not eng.step():
            break
    assert eng.n_active == 0
    return [list(s.streamer.tokens) for s in seen.values()]


@pytest.mark.parametrize("kw", [{"steps_per_dispatch": 1}, {"steps_per_dispatch": 4},
                                {"spec_decode": True, "spec_k": 5},
                                {"max_inflight": 2}],
                         ids=["k1", "k4", "spec", "inflight2"])
def test_token_ids_match_the_reference_engine(kw):
    ref = _token_streams(jle, jq.init_params(jax.random.PRNGKey(3), JTINY), JTINY, **kw)
    got = _token_streams(ple, _reference_params(3), TINY, **kw)
    assert len(ref) == 3 and all(len(t) == 40 for t in ref)
    assert got == ref


def test_llm_phase_batching_check_on_seeded_layers():
    import torch

    import chip_smoke as cs
    from infernos_tpu_torch.cluster.model_actors import LLM_FULL_ENGINE, qwen_int8_init
    from infernos_tpu_torch.models import presets
    from infernos_tpu_torch.models.tokenizers import ByteTokenizer

    cfg = presets.QWEN_TINY
    params = qwen_int8_init(cfg, torch.device("cpu"), torch.float32)
    cs.seeded_layers(torch, params, 0)
    ecfg = dataclasses.replace(LLM_FULL_ENGINE, prompt_buckets=(64, 128),
                               max_total_tokens=192, max_new_tokens=24,
                               dtype=torch.float32)
    tok = ByteTokenizer()
    eng = LLMEngine(params, cfg, ecfg, detokenize=tok.detokenize, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [cs.llm_prompt(rng, n) for n in (5, 20, 40, 90)]
    together = cs.run_requests(eng, prompts, tok)["tokens"]
    alone = [cs.run_requests(eng, [p], tok)["tokens"][0] for p in prompts]
    assert [len(t) for t in together] == [24] * 4
    assert together == alone
    assert len({tuple(t) for t in together}) == 4  # the layers reach the tokens
