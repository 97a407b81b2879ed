"""The bilingual LiveTranslator call of ``tests/test_lt_bilingual_e2e.py``
on the port: both directions give real translations through real SIP and
RTP calls into the port's daemon graph (``build_cluster``), with the
trained tiny-real models from the port's loaders, fp32 on the CPU.

It drives ``chip_smoke.py``'s ``drive_sip_call`` (the ``sip_call`` phase on
the card): Alice (a ``FakePhone``) speaks a rendered speechlang utterance
(the port's ``audio/speechlang.py``); the audio that reaches Bob (a
``FarEnd``) is transcribed by the port's tiny STT and compared word for
word with the lexicon's Portuguese; then Bob speaks Portuguese and Alice
must hear English.  Tolerance: word accuracy >= 0.6 each way, as the
original holds it.  After Alice hangs up, Bob must have the BYE and no
actor thread may be left.  The vendored corpus holds "quatro" and
"ajuda", so the test does not skip.

The tiny-real TTS output is a sample: SpeechT5's prenet dropout stays on
at inference, in both packages, and Griffin-Lim starts from a drawn
phase.  The port's draws (``torch.Generator``) cannot equal the
reference's (``jax.random``), and over twelve draws either package garbles
a word of this say now and then.  So the call runs on the reference's
draws (``tests/torch_reference_draws.py``), injected as
``test_torch_turn.py`` injects the Griffin-Lim phase:
each TTS engine's prenet masks come from the reference engine's key chain
(a key per tick from its seed counter, split per step and per prenet
layer), and the Griffin-Lim phase from the reference's fixed key.  The
port's engines, actors and media plane are otherwise as the daemon starts
them; the call is then the reference test's call.
Ports: SIP 25075 and 25085, RTP 34500-34900 (no other test file uses them).
"""

import json
import os

import pytest
import torch

import chip_smoke as cs
from infernos_tpu_torch.models.npz_io import data_path
from torch_reference_draws import reference_draws  # noqa: F401  (fixture)


@pytest.fixture(autouse=True)
def _two_threads():
    """The plain CPU path at two intra-op threads, as the port's other call
    tests run it (more intra-op threads than free cores slow it down)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_corpus_is_bilingual():
    with open(os.path.join(data_path("tiny_stt"), "corpus.json")) as f:
        assert {"quatro", "ajuda"} <= set(json.load(f)["words"])


@pytest.mark.e2e
def test_lt_translates_both_directions(reference_draws):
    call = cs.drive_sip_call(device="cpu")
    assert call["bob_got_bye"], "Bob did not get the BYE"
    assert call["actor_threads_left"] == []
    assert call["stt"].device == torch.device("cpu")
    heard = {}
    for d in call["directions"]:
        assert d.stt_results >= 1 and d.stt_text and all(d.stt_text), "no transcript on the way"
        hyp = cs.transcribe(call["stt"], cs.active_region(d.rx), d.tts_lang)
        heard[d.speaker] = (d.expect, hyp, cs.word_acc(d.expect, hyp))
    assert set(heard) == {"alice", "bob"}
    for spk, (expect, hyp, acc) in heard.items():
        assert acc >= cs.ACC_MIN, f"{spk}'s words: expected {expect!r}, got {hyp!r}"
