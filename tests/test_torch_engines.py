"""Port's STT and TTS engines vs the JAX engines, on the CPU.

STT: the in-repo trained tiny Whisper (``tiny_stt``), two rendered
utterances; the port must return the same token ids and text.
TTS: the in-repo trained tiny SpeechT5 + HiFi-GAN (``tiny_tts``) with
prenet dropout off in both; each tick's mel chunk and each audio chunk of
the port must match the JAX engine's (``fused_step=False``) within fp32
round-off scaled to the reference's peak (1e-4 of it for mels, 1e-3 for
audio after postnet and vocoder).
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from infernos_tpu.models import tiny_real
from infernos_tpu.serving import stt_engine as jstt
from infernos_tpu.serving import tts_engine as jtts
from infernos_tpu_torch.models import hifigan as hfg
from infernos_tpu_torch.models import speecht5 as st5
from infernos_tpu_torch.models import whisper as wsp
from infernos_tpu_torch.models.convert import from_jax_params
from infernos_tpu_torch.serving import stt_engine as stt
from infernos_tpu_torch.serving import tts_engine as tts


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(tree):
    return from_jax_params(jax.tree_util.tree_map(np.asarray, tree), "cpu")


def _same_cfg(cls, obj, **kw):
    fields = {f: getattr(obj, f) for f in cls.__dataclass_fields__ if hasattr(obj, f)}
    fields.update(kw)
    return cls(**fields)


def _render(text, seed):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
    from speechlang import Speaker, render_text

    rng = np.random.default_rng(seed)
    return render_text(rng, text, Speaker.random(rng)).astype(np.float32)


def _run_stt(eng, req_cls, audios):
    out = {}
    for i, a in enumerate(audios):
        eng.submit(req_cls(audio=a.copy(), text_cb=lambda r, i=i: out.__setitem__(i, r)))
    for _ in range(500):
        if not eng.step():
            break
    return [out[i] for i in range(len(audios))]


def test_stt_engine_same_tokens_as_jax_on_tiny_real():
    if not tiny_real.have_tiny_stt():
        pytest.fail("vendored tiny_stt checkpoint missing")
    jparams, jcfg, tok, jecfg = tiny_real.load_tiny_stt()
    audios = [_render("one two three", 1), _render("help me now", 2)]
    want = _run_stt(jstt.STTEngine(jparams, jcfg, jecfg, detokenize=tok.detokenize),
                    jstt.STTRequest, audios)
    cfg = _same_cfg(wsp.WhisperConfig, jcfg)
    ecfg = _same_cfg(stt.STTEngineConfig, jecfg, dtype=torch.float32)
    eng = stt.STTEngine(_port(jparams), cfg, ecfg, detokenize=tok.detokenize,
                        device="cpu")
    eng.warmup()  # leaves every slot free and the next results unchanged
    assert eng.n_active == 0
    got = _run_stt(eng, stt.STTRequest, audios)
    for g, w in zip(got, want):
        assert g.tokens == w.tokens
        assert g.text == w.text
        assert abs(g.no_speech_prob - w.no_speech_prob) < 1e-4
    assert any(len(w.tokens) > 0 for w in want)


ECFG_KW = dict(batch_slots=2, max_text_tokens=8, max_steps=16, pre_frames=2,
               chunk_schedule=(4, 8), min_steps=2, stop_threshold=2.0)


def _run_tts(eng, spk, record):
    """Two sessions to the end; ``record`` wraps the engine's ``_vocode`` so
    each tick's mel chunk (before postnet and vocoder) is kept."""
    got = {0: [], 1: []}
    eng._vocode = record(eng._vocode)
    eng.start_session(np.arange(2, 8, dtype=np.int32), spk[0],
                      got[0].append, max_frames=12)
    eng.start_session(np.arange(3, 6, dtype=np.int32), spk[1],
                      got[1].append, max_frames=20)
    for _ in range(50):
        if not eng.step():
            break
    return got


def test_tts_engine_audio_matches_jax_chunk_by_chunk():
    if not tiny_real.have_tiny_tts():
        pytest.fail("vendored tiny_tts checkpoint missing")
    jparams, jcfg, jvparams, jvoc, _, table = tiny_real.load_tiny_tts("hifigan")
    jcfg = dataclasses.replace(jcfg, speech_decoder_prenet_dropout=0.0)
    spk = np.asarray(table[:2], np.float32)

    want_mels = []

    def jax_record(vocode):
        def run(params, ctx, mels, *, n_frames):
            jax.debug.callback(lambda m: want_mels.append(np.asarray(m)), mels)
            return vocode(params, ctx, mels, n_frames=n_frames)
        return run

    want = _run_tts(jtts.TTSEngine(jparams, jcfg, jvparams, jvoc,
                                   jtts.TTSEngineConfig(fused_step=False, **ECFG_KW)),
                    spk, jax_record)
    jax.effects_barrier()

    got_mels = []

    def port_record(vocode):
        def run(mels, n_frames):
            got_mels.append(mels.numpy().copy())
            return vocode(mels, n_frames)
        return run

    cfg = _same_cfg(st5.SpeechT5Config, jcfg)
    eng = tts.TTSEngine(_port(jparams), cfg, _port(jvparams),
                        _same_cfg(hfg.HifiGanConfig, jvoc),
                        tts.TTSEngineConfig(**ECFG_KW), device="cpu")
    eng.warmup()  # leaves every slot free and the next audio unchanged
    assert eng.n_active == 0
    got = _run_tts(eng, spk, port_record)
    # trained weights: real mel and audio levels, so the tolerances below
    # (fp32 round-off, scaled to the reference's peak) fail a wrong value
    assert len(got_mels) == len(want_mels) > 0
    for g, w in zip(got_mels, want_mels):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * np.abs(w).max())
    for s in (0, 1):
        assert len(got[s]) == len(want[s]) and got[s][-1] is None
        assert want[s][-1] is None
        for g, w in zip(got[s][:-1], want[s][:-1]):
            w = np.asarray(w)
            assert g.shape == w.shape and g.shape[0] % 256 == 0
            assert np.abs(w).max() > 1e-2  # audible, not a near-silent chunk
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-3 * np.abs(w).max())
    assert sum(c.shape[0] for c in got[1][:-1]) == 20 * 256


def _tiny_tts_engine(**kw):
    jparams, jcfg, jvparams, jvoc, _, table = tiny_real.load_tiny_tts("hifigan")
    jcfg = dataclasses.replace(jcfg, speech_decoder_prenet_dropout=0.0)
    eng = tts.TTSEngine(_port(jparams), _same_cfg(st5.SpeechT5Config, jcfg),
                        _port(jvparams), _same_cfg(hfg.HifiGanConfig, jvoc),
                        tts.TTSEngineConfig(**{**ECFG_KW, **kw}), device="cpu")
    return eng, np.asarray(table[:2], np.float32)


@pytest.mark.parametrize("max_inflight", [1, 2])
def test_tts_engine_async_harvest_delivers_the_sync_audio(max_inflight):
    """With a uniform chunk schedule (so that chunk sizes do not depend on
    when the harvest thread runs) async harvest delivers exactly the sync
    engine's chunks, and ``close`` stops its thread."""
    outs = []
    for kw in (dict(), dict(async_harvest=True, max_inflight_ticks=max_inflight)):
        eng, spk = _tiny_tts_engine(chunk_schedule=(4,), **kw)
        got = {0: [], 1: []}
        eng.start_session(np.arange(2, 8, dtype=np.int32), spk[0], got[0].append,
                          max_frames=12)
        eng.start_session(np.arange(3, 6, dtype=np.int32), spk[1], got[1].append,
                          max_frames=20)
        for _ in range(100):
            if not eng.step():
                break
        eng.close()
        if kw:
            eng._hthread.join(timeout=10)
            assert not eng._hthread.is_alive()
        assert eng.n_active == 0
        outs.append(got)
    for s in (0, 1):
        assert len(outs[0][s]) == len(outs[1][s]) and outs[1][s][-1] is None
        for a, b in zip(outs[0][s][:-1], outs[1][s][:-1]):
            np.testing.assert_array_equal(a, b)
    assert sum(len(c) for c in outs[1][1][:-1]) == 20 * 256


def test_tts_engine_abort_all_ends_live_and_queued_sessions():
    eng, spk = _tiny_tts_engine()
    got = {i: [] for i in range(3)}  # 2 slots: the third stays queued
    for i in range(3):
        eng.start_session(np.arange(2, 6, dtype=np.int32), spk[i % 2], got[i].append)
    eng.step()
    assert eng.n_active == 2
    eng.abort_all("test")
    assert all(got[i] and got[i][-1] is None for i in range(3))
    assert eng.n_active == 0 and not eng.step()
    assert not bool(eng.state.active.any())
