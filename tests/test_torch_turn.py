"""One translated call turn as a whole, port vs JAX package, on the CPU.

One rendered utterance (``tools/speechlang``) as G.711 mu-law payloads of
20 ms goes through VADChannel + VADWorker (trained ``vad_weights.npz``) ->
STTSession -> TieredSTTEngine (trained ``tiny_stt``) -> translation,
numbers to words, sentence regrouping -> TTSSession -> TTSEngine over the
int8-quantized trained ``tiny_tts`` (``quantize_params(min_size=0)``: the
tiny decoder's matrices are below the default size) -> TTSSoundDispatch
with ``output_norm_rms`` -> 8 kHz G.711 frames of 160 bytes; engines are
stepped by EngineDrivers.  The chain is built once from the port's classes
and once from the JAX package's (its TTS engine with ``fused_step=False``
on the same quantized tree), prenet dropout off in both.

Held: the same VAD segment, token ids, text and translated text; each mel
chunk within 1e-4 and each audio chunk within 1e-3 of the reference's peak
(the tolerances of ``test_torch_engines.py``); and the port's chunks with
``async_harvest=True`` equal to those with ``False``.  The chunk schedule
is uniform, so that chunk sizes do not depend on when a harvest thread
happens to run.

The port's side is built from the port's own loaders and tokenizers
(``infernos_tpu_torch.models.tiny_real`` with ``device="cpu"``, its
``ByteLevelBPE.detokenize`` and SentencePiece tokenizer, its VAD loader);
the reference's from the JAX package's.  The turn runs with the trained
HiFi-GAN vocoder and once more with the Griffin-Lim vocoder (tiny-real's
default), whose starting phase is the JAX draw in both packages (the port's
own draw is not bit-equal to it), to the same tolerances.
"""

import dataclasses
import sys
import threading
import types
from unittest import mock
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from infernos_tpu import t2t as jt2t
from infernos_tpu.audio import chunk as jchunk
from infernos_tpu.audio import markers as jmarkers
from infernos_tpu.audio.codecs.g711 import G711Codec as JG711
from infernos_tpu.audio.resample import resample as jresample
from infernos_tpu.models import quant as jquant
from infernos_tpu.models import tiny_real
from infernos_tpu.models import vad as jvad
from infernos_tpu.serving import driver as jdriver
from infernos_tpu.serving import sessions as jses
from infernos_tpu.serving import stt_tiered as jtier
from infernos_tpu.serving import tts_engine as jtts
from infernos_tpu.serving import vad_engine as jve
from infernos_tpu.t2t import lexicon as jlex
from infernos_tpu_torch import t2t
from infernos_tpu_torch.audio import chunk, markers
from infernos_tpu_torch.audio.codecs.g711 import G711Codec
from infernos_tpu_torch.models import quant
from infernos_tpu_torch.models import speecht5 as st5
from infernos_tpu_torch.models import vad
from infernos_tpu_torch.models import whisper as wsp
from infernos_tpu_torch.audio import griffinlim as gl
from infernos_tpu_torch.models import tiny_real as port_tiny_real
from infernos_tpu_torch.ops.tts_step import is_int8
from infernos_tpu_torch.serving import driver, sessions
from infernos_tpu_torch.serving import stt_engine as stt
from infernos_tpu_torch.serving import stt_tiered as tier
from infernos_tpu_torch.serving import tts_engine as tts
from infernos_tpu_torch.serving import vad_engine as ve
from infernos_tpu_torch.t2t import lexicon as lex

FRAME = 160
TTS_KW = dict(batch_slots=2, max_text_tokens=24, max_steps=16, pre_frames=2,
              chunk_schedule=(8,), min_steps=2, stop_threshold=2.0,
              output_norm_rms=0.05)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_phase(shape, device):
    """The JAX Griffin-Lim's starting phase, in place of the port's draw."""
    ph = jax.random.uniform(jax.random.PRNGKey(12345), tuple(shape), np.float32,
                            0.0, 2.0 * np.pi)
    return torch.from_numpy(np.array(ph)).to(device)


def _payload():
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
    from speechlang import Speaker, render_text

    rng = np.random.default_rng(1)
    wav16 = render_text(rng, "one two three", Speaker.random(rng)).astype(np.float32)
    sil = np.zeros(4000, np.float32)
    wav = np.concatenate([sil, jresample(wav16, 16000, 8000), sil, sil, sil])
    return JG711().encode(wav)


def _turn(ns, payload):
    """Drive one turn through the classes of ``ns``; returns what it saw."""
    seen = types.SimpleNamespace(segments=[], results=[], said=[], chunks=[],
                                 markers=0, frames=[], errors=[])
    done, tail, lock = threading.Event(), [b""], threading.Lock()
    codec = ns.codec()
    translator = ns.t2t.Translator("en", "pt", backend=ns.lexicon.LexiconBackend())
    n2w = ns.t2t.NumbersToWords("pt")
    stt_sess = ns.sessions.STTSession(ns.stt_eng)
    tts_sess = ns.sessions.TTSSession(ns.tts_eng, ns.tokenize)
    stt_drv = ns.driver.EngineDriver(ns.stt_eng, name="stt")
    tts_drv = ns.driver.EngineDriver(ns.tts_eng, name="tts")
    worker = ns.ve.VADWorker(ns.vad_factory)

    def guard(fn):
        def run(*a):
            try:
                return fn(*a)
            except Exception as e:
                seen.errors.append(e)
                done.set()
                raise
        return run

    @guard
    def soundout(item):
        with lock:
            if isinstance(item, ns.chunk.AudioChunk):
                seen.chunks.append(np.asarray(item.audio).copy())
                pcm = ns.chunk.AudioChunk(item.audio.copy(), item.samplerate).resample(8000)
                tail[0] += codec.encode(pcm.audio)
            else:
                assert isinstance(item, ns.markers.ASMarkerNewSent)
                seen.markers += 1
                tail[0] += codec.silence(-len(tail[0]) % FRAME)
            while len(tail[0]) >= FRAME:
                seen.frames.append(tail[0][:FRAME])
                tail[0] = tail[0][FRAME:]
        if isinstance(item, ns.markers.ASMarkerSentDoneCB):
            item.on_proc()

    @guard
    def text_in(res):
        seen.results.append(res)
        translated = translator.translate(res.text.strip())
        groups = ns.t2t.regroup_sentences(ns.t2t.sent_split(n2w(translated)))
        seen.said.append((translated, groups))
        tts_sess.say(ns.sessions.TTSRequest(groups, done_cb=done.set))
        tts_drv.kick()

    @guard
    def vad_chunk_in(c):
        seen.segments.append((c.ipos, len(c.audio)))
        stt_sess.soundin(ns.sessions.STTRequest(chunk=c, text_cb=text_in))
        stt_drv.kick()

    tts_sess.start(soundout)
    ch = ns.ve.VADChannel(lambda c, active: None, vad_chunk_in, codec)
    threads = [worker, stt_drv, tts_drv]
    for t in threads:
        t.start()
    try:
        for i in range(0, len(payload) - FRAME + 1, FRAME):
            ch.ingest(worker, payload[i:i + FRAME])
        assert done.wait(timeout=240), "the turn did not finish in time"
    finally:
        for t in threads:
            t.stop(join=False)
        for t in threads:
            t.join(timeout=20)
        if hasattr(ns.tts_eng, "close"):
            ns.tts_eng.close()
    assert not any(t.is_alive() for t in threads)
    if seen.errors:
        raise seen.errors[0]
    assert tail[0] == b""
    return seen


@pytest.fixture(scope="module")
def weights():
    for have in (tiny_real.have_tiny_stt, tiny_real.have_tiny_tts,
                 port_tiny_real.have_tiny_stt, port_tiny_real.have_tiny_tts):
        if not have():
            pytest.fail("vendored tiny checkpoints missing")
    jsp, jscfg, stok, jsecfg = tiny_real.load_tiny_stt()
    jsecfg = dataclasses.replace(jsecfg, max_new_tokens=24)
    jvadp = jvad.load_pretrained()
    # the port's side: its own loaders and tokenizers alone
    sp, scfg, pstok, secfg = port_tiny_real.load_tiny_stt(device="cpu")
    secfg = dataclasses.replace(secfg, max_new_tokens=24)
    vadp = vad.load_pretrained("cpu")
    return types.SimpleNamespace(**locals())


def _tts_pair(vocoder):
    """(JAX, port) tiny TTS for ``vocoder``, each from its own package's
    loader, prenet dropout off."""
    jtp, jtcfg, jvp, jvcfg, jttok, _ = tiny_real.load_tiny_tts(vocoder)
    jtcfg = dataclasses.replace(jtcfg, speech_decoder_prenet_dropout=0.0)
    tp, tcfg, vp, vcfg, ttok, _ = port_tiny_real.load_tiny_tts(vocoder, device="cpu")
    tcfg = dataclasses.replace(tcfg, speech_decoder_prenet_dropout=0.0)
    return (jtp, jtcfg, jvp, jvcfg, jttok), (tp, tcfg, vp, vcfg, ttok)


def _reference_turn(weights, vocoder):
    """The turn through the JAX package's classes."""
    w = weights
    jtp, jtcfg, jvp, jvcfg, jttok = _tts_pair(vocoder)[0]
    jq = jquant.quantize_params(jtp, min_size=0)
    assert "w_q" in jq["dec_layers"]["self_attn"]["q"]
    mels = []
    tts_eng = jtts.TTSEngine(jq, jtcfg, jvp, jvcfg,
                             jtts.TTSEngineConfig(fused_step=False, **TTS_KW))
    vocode = tts_eng._vocode

    def record(params, ctx, m, *, n_frames):
        jax.debug.callback(lambda a: mels.append(np.asarray(a)), m)
        return vocode(params, ctx, m, n_frames=n_frames)

    tts_eng._vocode = record
    ns = types.SimpleNamespace(
        codec=JG711, t2t=jt2t, lexicon=jlex, sessions=jses, driver=jdriver,
        ve=jve, chunk=jchunk, markers=jmarkers, tokenize=jttok,
        vad_factory=lambda n: jvad.NumpyVAD(w.jvadp, jvad.VADConfig(), n),
        stt_eng=jtier.TieredSTTEngine(
            w.jsp, w.jscfg, jtier.TieredSTTConfig(short_max_s=2, short_slots=2,
                                                  long_slots=1, base=w.jsecfg),
            detokenize=w.stok.detokenize),
        tts_eng=tts_eng)
    seen = _turn(ns, _payload())
    jax.effects_barrier()
    seen.mels = mels
    return seen


@pytest.fixture(scope="module")
def reference(weights):
    return _reference_turn(weights, "hifigan")


def _port_turn(weights, async_harvest, vocoder="hifigan"):
    w = weights
    tp, tcfg, vp, vcfg, ttok = _tts_pair(vocoder)[1]
    qparams = quant.quantize_params(tp, min_size=0)
    mels = []
    tts_eng = tts.TTSEngine(
        qparams, tcfg, vp, vcfg,
        tts.TTSEngineConfig(async_harvest=async_harvest, **TTS_KW), device="cpu")
    assert is_int8(tts_eng.packed)
    assert isinstance(vcfg, gl.GriffinLimConfig) == (vocoder == "gl")
    vocode = tts_eng._vocode

    def record(m, n_frames):
        mels.append(m.numpy().copy())
        return vocode(m, n_frames)

    tts_eng._vocode = record
    ns = types.SimpleNamespace(
        codec=G711Codec, t2t=t2t, lexicon=lex, sessions=sessions, driver=driver,
        ve=ve, chunk=chunk, markers=markers, tokenize=ttok,
        vad_factory=lambda n: vad.NeuralVAD(w.vadp, vad.VADConfig(), n, device="cpu"),
        stt_eng=tier.TieredSTTEngine(
            w.sp, w.scfg,
            tier.TieredSTTConfig(short_max_s=2, short_slots=2, long_slots=1, base=w.secfg),
            detokenize=w.pstok.detokenize, device="cpu"),
        tts_eng=tts_eng)
    seen = _turn(ns, _payload())
    seen.mels = mels
    return seen


@pytest.fixture(scope="module")
def port_runs(weights):
    return {False: _port_turn(weights, False), True: _port_turn(weights, True)}


@pytest.fixture(scope="module")
def griffinlim_runs(weights):
    """The turn with the Griffin-Lim vocoder in both packages; the port's
    vocoder starts from the JAX package's phase draw."""
    with mock.patch.object(gl, "init_phase", _jax_phase):
        got = _port_turn(weights, False, vocoder="gl")
    return _reference_turn(weights, "gl"), got


@pytest.mark.parametrize("async_harvest", [False, True], ids=["sync", "async"])
def test_turn_matches_reference(reference, port_runs, async_harvest):
    _assert_turn_matches(reference, port_runs[async_harvest])


def test_griffinlim_turn_matches_reference(griffinlim_runs):
    _assert_turn_matches(*griffinlim_runs)


def _assert_turn_matches(want, got):
    assert len(want.segments) == 1 and got.segments == want.segments
    assert len(want.results) == 1
    assert got.results[0].tokens == want.results[0].tokens
    assert len(want.results[0].tokens) > 0
    assert got.results[0].text == want.results[0].text
    assert got.said == want.said and want.said[0][1]  # translated text and groups
    assert want.said[0][0] != want.results[0].text  # the lexicon did translate
    n_says = len(want.said[0][1])
    assert got.markers == want.markers == n_says
    # mel chunks of the ticks that carry the says (an engine may have
    # dispatched one more tick before the harvest told it the say was over),
    # audio chunks of every say
    n_ticks = 4 * n_says  # 32 frames in ticks of 8
    assert len(got.mels) >= n_ticks and len(want.mels) >= n_ticks
    for g, w_ in zip(got.mels[:n_ticks], want.mels[:n_ticks]):
        np.testing.assert_allclose(g, w_, rtol=1e-4, atol=1e-4 * np.abs(w_).max())
    assert len(got.chunks) == len(want.chunks) == n_ticks
    for g, w_ in zip(got.chunks, want.chunks):
        assert g.shape == w_.shape == (8 * 256,)
        assert np.abs(w_).max() > 1e-2  # audible after the gain lock
        np.testing.assert_allclose(g, w_, rtol=1e-4, atol=1e-3 * np.abs(w_).max())
    # the out stream: whole 20 ms frames, nearly the reference's bytes (a
    # sample within 1e-3 of the peak may land on the neighbouring code)
    assert len(got.frames) == len(want.frames) >= 20 * n_says
    assert all(len(f) == FRAME for f in got.frames)
    a = np.frombuffer(b"".join(got.frames), np.uint8)
    b = np.frombuffer(b"".join(want.frames), np.uint8)
    assert np.mean(a != b) < 0.05


def test_async_harvest_gives_the_same_chunks(port_runs):
    sync, asyn = port_runs[False], port_runs[True]
    assert len(sync.chunks) == len(asyn.chunks) > 0
    for a, b in zip(sync.chunks, asyn.chunks):
        np.testing.assert_array_equal(a, b)
    assert sync.frames == asyn.frames
    assert sync.results[0].tokens == asyn.results[0].tokens
