"""The port's engines emit the JAX engines' metrics.

The same tiny-real requests go through both packages' STT, TTS and LLM
engines (fp32 on the CPU), each package's engine modules writing to a fresh
``Metrics`` registry.  Both registries must hold the same metric names, and
equal values for the counters and gauges and equal counts for every
observation (the observed values are times, except ``stt.audio_s``, the
utterances' seconds, which must be equal too, to 1e-9).  One poisoned
request and one poisoned session exercise the quarantine counters.  Prenet
dropout is off in both, so both decoders stop on the same step.  The LLM
engines (``llm.*``) serve the same chat requests with K 4 decode steps per
dispatch and with speculative decode, and quarantine one poisoned request.
"""

import dataclasses

import numpy as np
import pytest
import torch

import infernos_tpu.serving.llm_engine as jllm
import infernos_tpu.serving.stt_engine as jstt
import infernos_tpu.serving.tts_engine as jtts
from infernos_tpu.models import tiny_real as jtiny
from infernos_tpu.models.tokenizers import ByteTokenizer as JByteTokenizer
from infernos_tpu.utils.metrics import Metrics as JMetrics
import infernos_tpu_torch.serving.llm_engine as pllm
import infernos_tpu_torch.serving.stt_engine as pstt
import infernos_tpu_torch.serving.tts_engine as ptts
from infernos_tpu_torch.audio import speechlang
from infernos_tpu_torch.audio.chunk import AudioChunk
from infernos_tpu_torch.models import tiny_real as ptiny
from infernos_tpu_torch.models.tokenizers import ByteTokenizer
from infernos_tpu_torch.utils.metrics import Metrics as PMetrics

TTS_KW = dict(batch_slots=4, max_text_tokens=48, max_steps=60, stop_threshold=0.5)
TEXTS = ("favor ajuda agora", "quero ajuda")
SAYINGS = (("please help now", 5), ("want help today", 7))
CHATS = ("<incoming call from agent (445572)>", "transfer me to billing please",
         "what is my order status")
LLM_KW = dict(batch_slots=2, prompt_buckets=(128, 256, 384), max_total_tokens=448,
              max_new_tokens=64)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _speech(text, seed):
    rng = np.random.default_rng(seed)
    a16 = speechlang.render_text(rng, text, speechlang.Speaker.random(rng))
    return AudioChunk(a16, 16000).audio


def _run_stt(mod, eng):
    out = []
    for text, seed in SAYINGS:
        eng.submit(mod.STTRequest(audio=_speech(text, seed), text_cb=out.append))
    # a poisoned request (non-numeric context ids) fails alone
    eng.submit(mod.STTRequest(audio=_speech("now", 3), text_cb=out.append,
                              context=np.array(["bogus"])))
    while eng.step():
        pass
    return out


def _run_tts(eng, tok, table):
    ends = []
    for i, text in enumerate(TEXTS):
        eng.start_session(np.asarray(tok.encode(text)), table[i],
                          lambda a, i=i: ends.append(i) if a is None else None)
    # a poisoned session (speaker vector of the wrong width) gets EOS alone
    eng.start_session(np.asarray(tok.encode("agora")), np.zeros(3, np.float32),
                      lambda a: ends.append("poison") if a is None else None)
    while eng.step():
        pass
    return sorted(map(str, ends))


def _split(reg):
    snap = reg.snapshot()
    hists = set(reg.hists)
    counts = {f"{h}.count": snap[f"{h}.count"] for h in hists}
    scalars = {k: v for k, v in snap.items()
               if not any(k.startswith(h + ".") for h in hists)}
    return set(snap), scalars, counts


def test_engines_emit_the_same_metrics(monkeypatch):
    jreg, preg = JMetrics(), PMetrics()
    for mod in (jstt, jtts):
        monkeypatch.setattr(mod, "metrics", jreg)
    for mod in (pstt, ptts):
        monkeypatch.setattr(mod, "metrics", preg)

    jsp, jscfg, jstok, jsecfg = jtiny.load_tiny_stt()
    j_stt = jstt.STTEngine(jsp, jscfg, jsecfg, detokenize=jstok.detokenize)
    sp, scfg, stok, secfg = ptiny.load_tiny_stt("cpu")
    p_stt = pstt.STTEngine(sp, scfg, secfg, detokenize=stok.detokenize,
                           device="cpu")
    j_out, p_out = _run_stt(jstt, j_stt), _run_stt(pstt, p_stt)
    assert [r.text for r in p_out] == [r.text for r in j_out]
    assert sum(r.text == "" and r.duration == 0.0 for r in p_out) == 1

    jtp, jtcfg, jvp, jvcfg, jtok, table = jtiny.load_tiny_tts("gl")
    jtcfg = dataclasses.replace(jtcfg, speech_decoder_prenet_dropout=0.0)
    j_tts = jtts.TTSEngine(jtp, jtcfg, jvp, jvcfg,
                           jtts.TTSEngineConfig(fused_step=False, **TTS_KW))
    tp, tcfg, vp, vcfg, tok, _ = ptiny.load_tiny_tts("gl", device="cpu")
    tcfg = dataclasses.replace(tcfg, speech_decoder_prenet_dropout=0.0)
    p_tts = ptts.TTSEngine(tp, tcfg, vp, vcfg, ptts.TTSEngineConfig(**TTS_KW),
                           device="cpu")
    assert _run_tts(p_tts, tok, table) == _run_tts(j_tts, jtok, table) \
        == ["0", "1", "poison"]

    j_names, j_scalars, j_counts = _split(jreg)
    p_names, p_scalars, p_counts = _split(preg)
    assert p_names == j_names
    assert {"stt.inf_time.count", "stt.audio_s.count", "stt.poisoned_requests",
            "tts.queue_wait.count", "tts.audio_samples", "tts.session_s.count",
            "tts.active_slots", "tts.poisoned_sessions"} <= p_names
    assert p_scalars == j_scalars
    assert p_counts == j_counts
    np.testing.assert_allclose(preg.hists["stt.audio_s"].values,
                               jreg.hists["stt.audio_s"].values, atol=1e-9)


def _run_llm(mod, params, cfg, tok, **kw):
    eng = mod.LLMEngine(params, cfg, mod.LLMEngineConfig(**LLM_KW, **kw),
                        detokenize=tok.detokenize,
                        **({"device": "cpu"} if mod is pllm else {}))
    out = []
    for text in CHATS:
        prompt = mod.apply_chat_template([{"role": "system", "content": "be brief"},
                                          {"role": "user", "content": text}])
        eng.submit(mod.LLMRequest(tok(prompt), lambda s, fin: fin and out.append(s)))
    # a poisoned request (non-numeric ids) finishes alone, empty
    eng.submit(mod.LLMRequest(np.array(["bogus"]), lambda s, fin: fin and out.append(s)))
    while eng.step():
        pass
    return sorted(out)


def test_llm_engines_emit_the_same_metrics(monkeypatch):
    jreg, preg = JMetrics(), PMetrics()
    monkeypatch.setattr(jllm, "metrics", jreg)
    monkeypatch.setattr(pllm, "metrics", preg)
    jparams, jcfg = jtiny.load_tiny_llm()
    params, cfg = ptiny.load_tiny_llm("cpu")
    for kw in ({"steps_per_dispatch": 4}, {"spec_decode": True, "spec_k": 4}):
        j_out = _run_llm(jllm, jparams, jcfg, JByteTokenizer(), **kw)
        p_out = _run_llm(pllm, params, cfg, ByteTokenizer(), **kw)
        assert p_out == j_out and "" in p_out and len(p_out) == len(CHATS) + 1
    j_names, j_scalars, j_counts = _split(jreg)
    p_names, p_scalars, p_counts = _split(preg)
    assert p_names == j_names
    assert {"llm.gen_time.count", "llm.tokens", "llm.poisoned_requests",
            "llm.spec_emit.count"} <= p_names
    assert p_scalars == j_scalars and p_scalars["llm.poisoned_requests"] == 2
    assert p_counts == j_counts and p_counts["llm.gen_time.count"] == 2 * len(CHATS)
