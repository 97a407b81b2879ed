"""The port's model actors against the JAX package's.

- Tiny-real (``INFERNOS_MODEL_MODE=tiny-real``, ``INFERNOS_TTS_VOCODER=
  hifigan``; fp32 on the CPU): both packages' ``STTActor`` transcribe the
  same rendered utterances through the session API to equal transcripts,
  and both packages' ``TTSActor`` say the same text with the same speaker to
  audio within 1e-3 of its peak (as ``test_torch_turn.py`` holds the
  engines; prenet dropout off in both, since the two draws differ).
- Tiny random starts: the JAX actor's weights, passed to the port's actor
  through ``params=`` (``models/convert.py`` ``from_jax_params``), give the
  same token ids for the same audio (random weights never emit EOS, so the
  ids up to the actor's 8-token cap are compared).
- A tiny random STT session with context decodes its second utterance
  (the tiny config's ``sot_prev`` lies inside its vocabulary).
- Full-dims starts without weights zero-initialise on the device in the
  serving dtype, with the tree that ``init_params`` makes; the full LLM
  start makes the int8 tree of ``quantize_params(init_params(...))`` at
  Qwen2.5-7B dims (traced with fake tensors here: no memory), codes int8,
  scales fp32, with a random embedding and readout and a final norm of ones.
- ``LLMActor``: tiny-real (the trained tiny LLM) and tiny random (the JAX
  actor's weights through ``params=``) give the JAX actor's replies through
  the session API.
- ``device`` reaches the engines; without a card and without
  ``device="cpu"`` an actor's start raises.
- ``INFERNOS_MODEL_MODE=tiny-real`` without the trained checkpoint raises
  in each actor's start.
"""

import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch

import chip_smoke as cs
import infernos_tpu.models.tiny_real as jtiny
import infernos_tpu.serving.sessions as jses
from infernos_tpu.audio.chunk import AudioChunk as JChunk
from infernos_tpu.cluster.actors import spawn as jspawn
from infernos_tpu.cluster.model_actors import LLMActor as JLLMActor
from infernos_tpu.cluster.model_actors import STTActor as JSTTActor
from infernos_tpu.cluster.model_actors import TTSActor as JTTSActor
import infernos_tpu_torch.models.tiny_real as ptiny
import infernos_tpu_torch.serving.sessions as pses
from infernos_tpu_torch.audio import speechlang
from infernos_tpu_torch.audio.chunk import AudioChunk
from infernos_tpu_torch.cluster import model_actors as ma
from infernos_tpu_torch.cluster.actors import spawn
from infernos_tpu_torch.models import presets, quant
from infernos_tpu_torch.models import qwen
from infernos_tpu_torch.models import speecht5 as st5
from infernos_tpu_torch.models import whisper as wsp
from infernos_tpu_torch.models.convert import from_jax_params

AUDIO_TOL = 1e-3  # of the say's peak, as test_torch_turn.py holds the engines
SAYINGS = (("please help now", 5), ("quero ajuda hoje", 7))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _speech8k(text, seed):
    rng = np.random.default_rng(seed)
    a16 = speechlang.render_text(rng, text, speechlang.Speaker.random(rng))
    return AudioChunk(a16, 16000).resample(8000).audio


def _no_dropout(monkeypatch, mod):
    load = mod.load_tiny_tts

    def load_without_dropout(*a, **kw):
        out = list(load(*a, **kw))
        out[1] = dataclasses.replace(out[1], speech_decoder_prenet_dropout=0.0)
        return tuple(out)

    monkeypatch.setattr(mod, "load_tiny_tts", load_without_dropout)


def _transcripts(actor, ses, chunk_cls, lang):
    sid = actor.ask_sync("new_stt_session", False)
    out, done = [], threading.Event()
    for text, seed in SAYINGS:
        def cb(res, n=len(SAYINGS)):
            out.append(res)
            if len(out) == n:
                done.set()
        actor.call("stt_session_soundin", sid, ses.STTRequest(
            chunk=chunk_cls(_speech8k(text, seed), 8000), text_cb=cb, lang=lang))
    assert done.wait(120.0), "STT actor did not answer"
    actor.ask_sync("stt_session_end", sid)
    return [(r.text, r.tokens) for r in out]


def _say(actor, ses, text, speaker_id):
    sid = actor.ask_sync("new_tts_session")
    chunks, done = [], threading.Event()

    def soundout(item):  # a playout end: the done marker fires here
        if hasattr(item, "on_proc"):
            item.on_proc()
        else:
            chunks.append(np.asarray(item.audio))

    actor.ask_sync("tts_session_start", sid, soundout)
    actor.ask_sync("tts_session_say", sid,
                   ses.TTSRequest(text, speaker_id=speaker_id, done_cb=done.set))
    assert done.wait(120.0), "TTS actor did not finish the say"
    actor.ask_sync("tts_session_end", sid)
    return np.concatenate(chunks)


def test_tiny_real_actors_match_the_reference(monkeypatch):
    monkeypatch.setenv("INFERNOS_MODEL_MODE", "tiny-real")
    monkeypatch.setenv("INFERNOS_TTS_VOCODER", "hifigan")
    _no_dropout(monkeypatch, jtiny)
    _no_dropout(monkeypatch, ptiny)
    actors = [jspawn(JSTTActor, name="j-stt"), spawn(ma.STTActor, device="cpu", name="p-stt"),
              jspawn(JTTSActor, name="j-tts"), spawn(ma.TTSActor, device="cpu", name="p-tts")]
    try:
        for a in actors[:2]:
            a.ask_sync("start", timeout=300)
        for a in actors[2:]:
            a.ask_sync("start", "pt", timeout=300)
        assert actors[1]._actor.engine.device == torch.device("cpu")
        assert actors[3]._actor.engine.ecfg.dtype == torch.float32
        j_txt = _transcripts(actors[0], jses, JChunk, "en")
        p_txt = _transcripts(actors[1], pses, AudioChunk, "en")
        assert p_txt == j_txt
        assert all(t for t, _ in p_txt)
        j_audio = _say(actors[2], jses, "favor ajuda agora", 3)
        p_audio = _say(actors[3], pses, "favor ajuda agora", 3)
        assert p_audio.shape == j_audio.shape and len(p_audio) > 4000
        peak = np.abs(j_audio).max()
        assert np.abs(p_audio - j_audio).max() <= AUDIO_TOL * peak
    finally:
        for a in actors:
            a.stop()


def test_tiny_random_stt_actor_on_reference_weights(monkeypatch):
    monkeypatch.delenv("INFERNOS_MODEL_MODE", raising=False)
    j = jspawn(JSTTActor, tiny=True, seed=3, name="j-stt-rand")
    p = None
    try:
        j.ask_sync("start", timeout=300)
        params = from_jax_params(
            jax.tree_util.tree_map(np.asarray, j._actor.engine.params), "cpu")
        p = spawn(ma.STTActor, tiny=True, params=params, device="cpu",
                  name="p-stt-rand")
        p.ask_sync("start", timeout=300)
        j_out = _transcripts(j, jses, JChunk, "en")
        p_out = _transcripts(p, pses, AudioChunk, "en")
        assert [tok for _, tok in p_out] == [tok for _, tok in j_out]
        assert all(len(tok) == 8 for _, tok in p_out)
    finally:
        j.stop()
        if p is not None:
            p.stop()


def test_tiny_random_stt_actor_takes_context(monkeypatch):
    """A session that keeps context prompts its second utterance with
    ``sot_prev``: the tiny config names one inside its vocabulary, so the
    request is decoded, not quarantined (8 tokens, the actor's cap)."""
    monkeypatch.delenv("INFERNOS_MODEL_MODE", raising=False)
    h = spawn(ma.STTActor, tiny=True, device="cpu", name="p-stt-ctx")
    try:
        h.ask_sync("start", timeout=300)
        assert h._actor.engine.ecfg.sot_prev < presets.WHISPER_TINY_TEST.vocab_size
        sid = h.ask_sync("new_stt_session", True)
        out, done = [], threading.Event()
        for text, seed in SAYINGS:
            h.call("stt_session_soundin", sid, pses.STTRequest(
                chunk=AudioChunk(_speech8k(text, seed), 8000),
                text_cb=lambda r: (out.append(r), len(out) == 2 and done.set())))
        assert done.wait(120.0)
        assert [len(r.tokens) for r in out] == [8, 8]
    finally:
        h.stop()


@pytest.mark.parametrize("what", ["whisper", "speecht5"])
def test_zeros_init_allocates_the_init_tree_in_the_serving_dtype(what):
    cfg, mod = {"whisper": (presets.WHISPER_TINY_TEST, wsp),
                "speecht5": (presets.SPEECHT5_TINY, st5)}[what]
    ref = mod.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    got = ma.zeros_init(lambda g, d, t: mod.init_params(cfg, g, d, t),
                         torch.device("cpu"), torch.bfloat16)
    flat_ref, flat_got = [], []
    ma._tree_map(flat_ref.append, ref)
    ma._tree_map(flat_got.append, got)
    assert len(flat_got) == len(flat_ref) > 10
    for r, g in zip(flat_ref, flat_got):
        assert g.shape == r.shape and g.device == torch.device("cpu")
        assert g.dtype == (torch.bfloat16 if r.is_floating_point() else r.dtype)
        assert not g.any()


def _replies(actor, texts):
    """Each text sent in turn through one LLM session; the final replies."""
    sid = actor.ask_sync("new_llm_session", cs.TINY_LLM_PROMPT)
    out = []
    for text in texts:
        done = threading.Event()
        parts = []

        def cb(r, parts=parts, done=done):
            parts.append(r.text)
            if r.is_final:
                done.set()

        actor.call("llm_session_textin", sid, text, cb)
        assert done.wait(120.0), "LLM actor did not answer"
        out.append(" ".join(p for p in parts if p))
    actor.ask_sync("llm_session_end", sid)
    return out


CHATS = ("<incoming call from agent (445572)>", "transfer me to billing please")


def test_tiny_real_llm_actor_matches_the_reference(monkeypatch):
    monkeypatch.setenv("INFERNOS_MODEL_MODE", "tiny-real")
    j = jspawn(JLLMActor, name="j-llm")
    p = spawn(ma.LLMActor, device="cpu", name="p-llm")
    try:
        j.ask_sync("start", timeout=300)
        p.ask_sync("start", timeout=300)
        assert p._actor.engine.device == torch.device("cpu")
        assert p._actor.engine.ecfg.dtype == torch.float32
        got = _replies(p, CHATS)
        assert got == _replies(j, CHATS)
        assert got[0] == "hello this is the service team"
    finally:
        j.stop()
        p.stop()


def test_tiny_random_llm_actor_on_reference_weights(monkeypatch):
    monkeypatch.delenv("INFERNOS_MODEL_MODE", raising=False)
    j = jspawn(JLLMActor, tiny=True, seed=3, name="j-llm-rand")
    p = None
    try:
        j.ask_sync("start", timeout=300)
        params = from_jax_params(
            jax.tree_util.tree_map(np.asarray, j._actor.engine.params), "cpu")
        p = spawn(ma.LLMActor, tiny=True, params=params, device="cpu", name="p-llm-rand")
        p.ask_sync("start", timeout=300)
        got = _replies(p, CHATS)
        assert got == _replies(j, CHATS)
        assert p._actor.engine.ecfg.batch_slots == 2 and any(got)
    finally:
        j.stop()
        if p is not None:
            p.stop()


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("cfg_name", ["QWEN_TINY", "QWEN25_7B"])
def test_llm_full_start_makes_the_int8_tree(cfg_name):
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = getattr(presets, cfg_name)
    with FakeTensorMode():  # shapes and types only: 7B needs no memory here
        ref = dict(_flat(quant.quantize_params(
            qwen.init_params(cfg, torch.Generator(), "cpu", torch.bfloat16))))
        fake = dict(_flat(ma.qwen_int8_init(cfg, torch.device("cpu"), torch.bfloat16)))
        q_bytes = quant.quantized_bytes(dict(fake=list(fake.values())))
    assert set(fake) == set(ref)
    for k, r in ref.items():
        want = torch.float32 if k[-1] == "scale" else r.dtype
        assert fake[k].shape == r.shape and fake[k].dtype == want, k
    assert any(k[-1] == "w_q" for k in ref)
    if cfg_name == "QWEN25_7B":
        assert 8.5e9 < q_bytes < 9.0e9  # int8 codes + bf16 embedding/readout
        return
    got = dict(_flat(ma.qwen_int8_init(cfg, torch.device("cpu"), torch.bfloat16, seed=1)))
    for k, t in got.items():
        if k[0] in ("embed", "lm_head"):
            assert 0.015 < t.float().std() < 0.025, k
        elif k[0] == "ln_f":
            assert torch.equal(t, torch.ones_like(t))
        else:
            assert not t.any(), k


@pytest.mark.parametrize("cls", ["STTActor", "TTSActor", "LLMActor"])
def test_actor_start_demands_a_card_unless_cpu_is_asked(monkeypatch, cls):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("INFERNOS_MODEL_MODE", raising=False)
    actor = getattr(ma, cls)(tiny=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        actor.start()
    assert actor.engine is None


@pytest.mark.parametrize("cls,what", [("STTActor", "STT"), ("TTSActor", "TTS"),
                                      ("LLMActor", "LLM")])
def test_tiny_real_without_its_checkpoint_raises(monkeypatch, tmp_path, cls, what):
    """``INFERNOS_MODEL_MODE=tiny-real`` with the data path pointed at an
    empty directory: the start raises and names the directory; it does not
    serve random weights in the checkpoint's place."""
    monkeypatch.setenv("INFERNOS_MODEL_MODE", "tiny-real")
    monkeypatch.setenv(f"INFERNOS_TINY_DATA_TINY_{what}", str(tmp_path))
    actor = getattr(ma, cls)(tiny=True, device="cpu")
    with pytest.raises(RuntimeError, match=f"no trained tiny {what} checkpoint in {tmp_path}"):
        actor.start()
    assert actor.engine is None and actor.driver is None
