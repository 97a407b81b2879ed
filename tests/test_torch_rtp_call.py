"""The en->pt leg of a two-leg call over RTP, on the CPU, against the JAX package.

``chip_smoke.py``'s ``drive_rtp_call`` with the tiny-real pair from the
port's loaders (fp32, ``device="cpu"``, Griffin-Lim): a far end streams
"please help now" (rendered by the port's ``audio.speechlang``, seed 5) as G.711 RTP
over UDP on 127.0.0.1 at call pace into Alice's ``RTPEndpoint``; the shared
``RTPIngest`` (jitter buffer, ``NeuralVAD``) hands segments to STT, T2T and
TTS; Bob's endpoint paces the reply out (native pacer) to Bob's far end.

Held: what Bob's far end hears transcribes (the port's tiny STT) to at least
0.6 word accuracy against "favor ajuda agora", the bar of
``tests/test_lt_bilingual_e2e.py``; each STT request of the call, run
through the JAX package's tiny-real ``STTEngine`` on the same audio, context
and language, gives the same text, and the JAX lexicon translation of it
equals the port's.
"""

import shutil

import numpy as np
import pytest
import torch

import chip_smoke as cs


@pytest.fixture(scope="module")
def call():
    torch.set_num_threads(2)
    stt_eng, tts_eng, tok, bank = cs.tiny_real_engines("cpu")
    requests = []
    submit = stt_eng.submit

    def record(req):
        requests.append(req)
        return submit(req)

    stt_eng.submit = record
    out = cs.drive_rtp_call(stt_eng, tts_eng, tok, bank, device="cpu",
                            lines=cs.CALL_LINES[:1])
    stt_eng.submit = submit
    d = out["directions"][0]
    heard = cs.transcribe(stt_eng, cs.active_region(d.rx), d.tts_lang)
    return out, d, requests, heard


def test_the_listener_hears_the_translation(call):
    out, d, _, heard = call
    assert (d.speaker, d.listener, d.stt_lang, d.tts_lang) == ("alice", "bob", "en", "pt")
    assert d.segments and len(d.results) == len(d.segments)
    assert d.says >= 1 and d.says_done == d.says
    assert d.first_s and d.reply_start_s is not None and d.reply_start_s > 0
    acc = cs.word_acc(d.expect, heard)
    assert acc >= cs.ACC_MIN, (heard, d.expect, [r.text for r in d.results], d.translated)


def test_media_plane_is_the_native_one(call):
    out = call[0]
    if shutil.which("g++") is None:
        pytest.skip("no C++ compiler: the Python pacer carries the legs")
    assert out["native_engine"]
    assert out["writers"] == {"alice": "NativeLegWriter", "bob": "NativeLegWriter"}
    assert out["pacer_stats"]["bob"]["sent_pkts"] > 0
    assert out["far_sent_pkts"]["alice"] > 0 and out["far_rx_pkts"]["bob"] > 0


def test_stt_and_t2t_text_equal_jax(call):
    from infernos_tpu.models import tiny_real as jtr
    from infernos_tpu.serving.stt_engine import STTEngine, STTRequest
    from infernos_tpu.t2t import Translator
    from infernos_tpu.t2t.lexicon import LexiconBackend

    _, d, requests, _ = call
    assert len(requests) == len(d.results) >= 1
    params, cfg, tok, ecfg = jtr.load_tiny_stt()
    eng = STTEngine(params, cfg, ecfg, detokenize=tok.detokenize)
    translator = Translator("en", "pt", backend=LexiconBackend())
    translated = iter(d.translated)
    for req, res in zip(requests, d.results):
        got = []
        eng.submit(STTRequest(audio=np.asarray(req.audio), text_cb=got.append,
                              lang=req.lang, mode=req.mode, context=req.context,
                              max_ns_prob=req.max_ns_prob))
        while eng.step():
            pass
        assert got and got[0].text == res.text
        assert got[0].tokens == res.tokens
        if res.no_speech_prob <= 0.5 and res.text.strip():
            assert translator.translate(res.text.strip()) == next(translated)
