"""The STT decode-quality ladder and beam search on the port, on the CPU.

Port copies of ``tests/test_stt_engine.py``'s ladder and beam cases and of
``tests/test_whisper_tokens.py``'s prompt cases, beside parity with the JAX
package on one set of weights (``models/convert.py`` ``from_jax_params``):

- ``whisper.beam_decode`` with W 1 and 3: token ids equal, sum logprob
  within 1e-4 relative, fp32;
- the sampled decode dispatch on the reference's Gumbel draws (injected in
  place of the port's generator, whose draws cannot equal ``jax.random``'s):
  token ids equal;
- greedy decoding: tokens and logprobs equal the JAX engine's, also for a
  greedy slot that shares its dispatches with a sampling one;
- ``build_prompt`` and ``STTEngineConfig.for_specials`` for v2 and v3.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infernos_tpu.models import whisper as jwsp
from infernos_tpu.models import whisper_tokens as jtok
from infernos_tpu.serving import stt_engine as jstt
from infernos_tpu_torch.models import whisper as wsp
from infernos_tpu_torch.models.convert import from_jax_params
from infernos_tpu_torch.models.whisper_tokens import (SPECIALS_V2, SPECIALS_V3,
                                                      build_prompt)
from infernos_tpu_torch.serving.stt_engine import (OPENAI_LADDER, STTEngine,
                                                   STTEngineConfig, STTRequest)
from infernos_tpu_torch.utils.metrics import metrics

TINY_KW = dict(vocab_size=100, num_mel_bins=20, d_model=32, encoder_layers=1,
               encoder_attention_heads=2, decoder_layers=1,
               decoder_attention_heads=2, ffn_dim=64, max_source_positions=100,
               max_target_positions=64, eos_token_id=2, sot_token_id=3,
               no_speech_token_id=4)
TINY = wsp.WhisperConfig(**TINY_KW)
JTINY = jwsp.WhisperConfig(**TINY_KW)
ENGINE_KW = dict(sample_rate=16000, max_new_tokens=8, max_prompt_tokens=8,
                 lang_tokens={"en": 10}, task_transcribe=12, task_translate=13,
                 no_timestamps=14, no_speech=4)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jparams(seed):
    return jwsp.init_params(jax.random.PRNGKey(seed), JTINY)


def _port(jparams):
    return from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), "cpu")


def _engine(seed=0, **kw):
    ecfg = STTEngineConfig(batch_slots=2, buckets_s=(1,), **ENGINE_KW, **kw)
    return STTEngine(_port(_jparams(seed)), TINY, ecfg, device="cpu")


def _audio(seconds, seed=0):
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal(int(16000 * seconds))).astype(np.float32)


def _drain(eng, limit=500):
    steps = 0
    while eng.step() and steps < limit:
        steps += 1


def _enc(jparams, seed):
    mel = 0.1 * np.random.default_rng(seed).standard_normal((1, 20, 50))
    return jwsp.encode(jparams, JTINY, jnp.asarray(mel, jnp.float32))


def _greedy_oracle(jparams, enc, prompt, max_new):
    """The greedy AR sequence by re-feeding the JAX package's full decoder."""
    toks, out = list(prompt), []
    for _ in range(max_new):
        logits = jwsp.decode_full(jparams, JTINY, jnp.asarray(
            np.asarray(toks, np.int32)[None]), enc)
        nxt = int(jnp.argmax(logits[0, -1]))
        if nxt == TINY.eos_token_id:
            break
        out.append(nxt)
        toks.append(nxt)
    return out


def _seq_logprob(jparams, enc, prompt, tokens):
    """Teacher-forced sum logprob of ``tokens`` after ``prompt``."""
    full = np.concatenate([prompt, tokens]).astype(np.int32)
    logits = jwsp.decode_full(jparams, JTINY, jnp.asarray(full[None]), enc)
    lp = jax.nn.log_softmax(logits[0].astype(jnp.float32), axis=-1)
    P = len(prompt)
    return float(sum(lp[P - 1 + i, t] for i, t in enumerate(tokens)))


def _beam(params, enc, prompt, W, max_new):
    tk, ng, lp = wsp.beam_decode(params, TINY, torch.from_numpy(np.array(enc)),
                                 torch.from_numpy(prompt), len(prompt),
                                 beam_size=W, max_new=max_new,
                                 eos_id=TINY.eos_token_id)
    return [int(t) for t in tk[: int(ng)]], float(lp)


# -- port copies of tests/test_stt_engine.py's ladder and beam cases ----------

def test_temperature_fallback_triggers_and_recovers():
    """On a low average logprob the engine decodes again at each rung's
    temperature; the caller sees exactly one (final) result."""
    before = metrics.counters.get("stt.fallback_retries", 0)
    # a positive threshold marks every decode low-confidence (avg <= 0)
    eng = _engine(fallback_temperatures=(0.5, 1.0), logprob_threshold=1.0)
    results = []
    req = STTRequest(audio=_audio(0.5), text_cb=results.append,
                     max_ns_prob=1.1)  # never classified as silence
    eng.submit(req)
    _drain(eng)
    assert len(results) == 1, "caller must see exactly one final result"
    res = results[0]
    assert res.temperature == 1.0  # the last rung produced it
    assert req.attempt == 2
    assert res.avg_logprob <= 0.0
    assert metrics.counters.get("stt.fallback_retries", 0) == before + 2


def test_fallback_disabled_by_default():
    eng = _engine()
    results = []
    req = STTRequest(audio=_audio(0.5), text_cb=results.append)
    eng.submit(req)
    _drain(eng)
    assert len(results) == 1
    assert results[0].temperature == 0.0 and req.attempt == 0
    assert eng.ecfg.fallback_beam_size == 0 and OPENAI_LADDER[-1] == 1.0


def test_beam_size_one_matches_greedy():
    """beam_decode(W=1) reproduces the greedy AR sequence exactly."""
    jp = _jparams(1)
    enc = _enc(jp, 0)
    prompt = np.asarray([3, 10, 12], np.int64)
    got, _ = _beam(_port(jp), enc, prompt, 1, 8)
    assert got == _greedy_oracle(jp, enc, prompt, 8)


def test_beam_logprob_not_worse_than_greedy():
    """A wider beam finds a sequence whose logprob is at least greedy's."""
    jp = _jparams(5)
    enc = _enc(jp, 3)
    prompt = np.asarray([3, 10, 12], np.int64)
    params = _port(jp)
    g_toks, g_lp = _beam(params, enc, prompt, 1, 6)
    b_toks, b_lp = _beam(params, enc, prompt, 4, 6)
    for toks, lp in ((g_toks, g_lp), (b_toks, b_lp)):
        if toks:
            ref = _seq_logprob(jp, enc, prompt, toks)
            # beam scores include the eos step for finished beams
            assert lp <= 0.0
            assert abs(ref - lp) < 2.5, (ref, lp)
    assert b_lp >= g_lp - 1e-4


def test_beam_rung_fires_after_ladder():
    """Gate fails and the temperatures are spent -> one beam re-decode (its
    encode counted with the engine's), one final result."""
    eng = _engine(fallback_temperatures=(0.5,), logprob_threshold=1.0,
                  fallback_beam_size=3)
    before = metrics.counters.get("stt.beam_redecodes", 0)
    results = []
    req = STTRequest(audio=_audio(0.5), text_cb=results.append,
                     max_ns_prob=1.1)
    eng.submit(req)
    _drain(eng)
    assert len(results) == 1
    assert req.beam_done
    assert metrics.counters.get("stt.beam_redecodes", 0) == before + 1
    assert all(0 <= t < TINY.vocab_size for t in results[0].tokens)
    assert len(eng.encode_ms) == 3  # greedy, T=0.5, beam


# -- parity with the JAX package ----------------------------------------------

@pytest.mark.parametrize("W", [1, 3])
def test_beam_decode_matches_jax(W):
    jp = _jparams(7)
    enc = _enc(jp, 4)
    prompt = np.asarray([3, 10, 12, 14, 0, 0, 0, 0], np.int64)
    P, max_new = 4, 8
    sup = jnp.zeros((TINY.vocab_size,), bool).at[jnp.asarray([5, 6])].set(True)
    begin = jnp.zeros((TINY.vocab_size,), bool).at[jnp.asarray([7])].set(True)
    jtk, jng, jlp = jwsp.beam_decode(
        jp, JTINY, enc, jnp.asarray(prompt, jnp.int32), jnp.int32(P),
        beam_size=W, max_new=max_new, eos_id=TINY.eos_token_id,
        suppress_mask=sup, begin_suppress_mask=begin, length_penalty=1.0)
    tk, ng, lp = wsp.beam_decode(
        _port(jp), TINY, torch.from_numpy(np.array(enc)),
        torch.from_numpy(prompt), P, beam_size=W, max_new=max_new,
        eos_id=TINY.eos_token_id,
        suppress_mask=torch.from_numpy(np.array(sup)),
        begin_suppress_mask=torch.from_numpy(np.array(begin)))
    assert int(ng) == int(jng)
    assert tk.tolist() == np.asarray(jtk).tolist()
    assert float(lp) == pytest.approx(float(jlp), rel=1e-4)


def _jengine(seed=0, **kw):
    ecfg = jstt.STTEngineConfig(batch_slots=2, buckets_s=(1,), **ENGINE_KW, **kw)
    return jstt.STTEngine(_jparams(seed), JTINY, ecfg)


def _run(eng, req_cls, specs):
    """Submit ``(seconds, seed, temperature)`` requests together; results in
    submit order."""
    out = {}
    for i, (sec, seed, temp) in enumerate(specs):
        eng.submit(req_cls(audio=_audio(sec, seed), max_ns_prob=1.1,
                           temperature=temp,
                           text_cb=lambda r, i=i: out.__setitem__(i, r)))
    _drain(eng)
    return [out[i] for i in range(len(specs))]


def _reference_gumbel(self, shape, step_i):
    """The JAX engine's draw for this dispatch and step (its ``_step``)."""
    key = jax.random.fold_in(jax.random.PRNGKey(np.uint32(self._seed)), step_i)
    return torch.from_numpy(np.asarray(jax.random.gumbel(key, tuple(shape),
                                                         jnp.float32)))


def test_sampled_dispatch_matches_jax_on_reference_draws():
    specs = [(0.5, 0, 0.7), (0.8, 1, 1.0)]
    want = _run(_jengine(3), jstt.STTRequest, specs)
    with mock.patch.object(STTEngine, "_gumbel", _reference_gumbel):
        got = _run(_engine(3), STTRequest, specs)
    for g, w in zip(got, want):
        assert g.tokens == w.tokens
        assert g.temperature == w.temperature
        assert g.avg_logprob == pytest.approx(w.avg_logprob, rel=1e-4, abs=1e-5)
    # the port's own draws sample too: a temperature changes the tokens
    own = _run(_engine(3), STTRequest, [(0.5, 0, 0.0), (0.5, 0, 5.0)])
    assert own[0].tokens != own[1].tokens


def test_greedy_tokens_and_logprobs_match_jax():
    """Greedy decoding is what it was before the ladder: the JAX engine's
    tokens and average logprobs, also for a greedy slot that shares its
    dispatches with a sampling one (the noise reaches sampled slots only)."""
    specs = [(0.5, 0, 0.0), (0.8, 1, 0.0)]
    want = _run(_jengine(3), jstt.STTRequest, specs)
    got = _run(_engine(3), STTRequest, specs)
    for g, w in zip(got, want):
        assert g.tokens == w.tokens
        assert g.avg_logprob == pytest.approx(w.avg_logprob, rel=1e-4, abs=1e-5)
    mixed = _run(_engine(3), STTRequest, [(0.5, 0, 0.0), (0.8, 1, 1.0)])
    assert mixed[0].tokens == got[0].tokens
    assert mixed[0].avg_logprob == got[0].avg_logprob


def test_greedy_tokens_unchanged_by_logprob_tracking():
    eng = _engine()
    a = _run(eng, STTRequest, [(1.0, 42, 0.0)])
    b = _run(eng, STTRequest, [(1.0, 42, 0.0)])
    assert a[0].tokens == b[0].tokens
    assert a[0].avg_logprob == pytest.approx(b[0].avg_logprob)


def test_ladder_fields_match_the_reference_config():
    names = ("fallback_temperatures", "logprob_threshold",
             "compression_ratio_threshold", "fallback_beam_size",
             "beam_length_penalty")
    ours, ref = STTEngineConfig(), jstt.STTEngineConfig()
    assert {n: getattr(ours, n) for n in names} == {n: getattr(ref, n) for n in names}
    assert OPENAI_LADDER == jstt.OPENAI_LADDER
    for field in ("temperature", "attempt", "beam_done"):
        assert getattr(STTRequest(audio=None, text_cb=None), field) == \
            getattr(jstt.STTRequest(audio=None, text_cb=None), field)


# -- port copies of tests/test_whisper_tokens.py's prompt cases ---------------

def test_prompt_plain_transcribe():
    ids, sot = build_prompt(SPECIALS_V3, "en")
    assert ids == [50258, 50259, 50360, 50364]
    assert sot == 0


def test_prompt_translate_timestamps():
    ids, sot = build_prompt(SPECIALS_V3, "fr", mode="translate",
                            timestamps=True)
    assert ids == [50258, 50265, 50359]
    assert sot == 0


def test_prompt_with_context_prefixes_startofprev():
    ctx = [100, 200, 300]
    ids, sot = build_prompt(SPECIALS_V3, "en", context=ctx)
    assert ids == [50362, 100, 200, 300, 50258, 50259, 50360, 50364]
    assert sot == 4
    assert ids[sot] == SPECIALS_V3.sot


def test_prompt_context_truncates_from_left():
    ctx = list(range(1000, 1100))
    ids, sot = build_prompt(SPECIALS_V3, "en", context=ctx,
                            max_prompt_tokens=12)
    # room = 12 - 4 (tail) - 1 (startofprev) = 7 context tokens, newest kept
    assert len(ids) == 12
    assert ids[0] == SPECIALS_V3.startofprev
    assert ids[1:8] == list(range(1093, 1100))
    assert ids[8:] == [50258, 50259, 50360, 50364]
    assert sot == 8


PROMPT_CASES = [
    ("en", "transcribe", False, None),
    ("pt", "translate", False, None),
    ("de", "transcribe", True, None),
    ("en", "transcribe", False, [11, 22, 33]),
    ("fr", "translate", True, list(range(500))),
]


def test_engine_prompt_matches_vendored_builder():
    """STTEngine._build_prompt emits the exact whisper_tokens layout."""

    class _Cfg:  # stand-in for WhisperConfig
        sot_token_id = SPECIALS_V3.sot
        vocab_size = SPECIALS_V3.vocab_size

    ecfg = STTEngineConfig.for_specials(SPECIALS_V3)
    eng = type("E", (), {})()  # no engine state: call the method unbound
    eng.ecfg = ecfg
    eng.cfg = _Cfg()
    for lang, mode, ts, ctx in PROMPT_CASES:
        req = STTRequest(audio=np.zeros(16, np.float32),
                         text_cb=lambda r: None, lang=lang, mode=mode,
                         timestamps=ts,
                         context=None if ctx is None else np.asarray(ctx))
        got, got_sot = STTEngine._build_prompt(eng, req)
        want, want_sot = build_prompt(
            SPECIALS_V3, lang, mode=mode, timestamps=ts, context=ctx,
            max_prompt_tokens=ecfg.max_prompt_tokens)
        assert got == want, (lang, mode, ts)
        assert got_sot == want_sot


def test_engine_config_for_specials_v2():
    e = STTEngineConfig.for_specials(SPECIALS_V2)
    assert e.no_speech == 50362 and e.sot_prev == 50361
    assert e.lang_tokens["en"] == 50259
    assert "yue" not in e.lang_tokens
    e3 = STTEngineConfig.for_specials(SPECIALS_V3)
    assert e3.no_speech == 50363 and e3.lang_tokens["yue"] == 50358


@pytest.mark.parametrize("v", ["v2", "v3"])
def test_build_prompt_and_for_specials_equal_the_reference(v):
    ours, ref = {"v2": (SPECIALS_V2, jtok.SPECIALS_V2),
                 "v3": (SPECIALS_V3, jtok.SPECIALS_V3)}[v]
    for lang, mode, ts, ctx in PROMPT_CASES:
        for cap in (8, 12, 32):
            assert build_prompt(ours, lang, mode, ts, ctx, cap) == \
                jtok.build_prompt(ref, lang, mode, ts, ctx, cap)
    got = STTEngineConfig.for_specials(ours, batch_slots=3)
    want = jstt.STTEngineConfig.for_specials(ref, batch_slots=3)
    for f in ("lang_tokens", "task_transcribe", "task_translate",
              "no_timestamps", "no_speech", "sot_prev", "batch_slots"):
        assert getattr(got, f) == getattr(want, f), f
