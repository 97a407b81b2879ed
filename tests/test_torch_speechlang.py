"""The port's speech renderer (``infernos_tpu_torch.audio.speechlang``)
against ``tools/speechlang.py``: the same generator gives the same samples,
exactly, for the far ends of ``chip_smoke.py``'s call and for a speaker and
noise level drawn inside ``render_text``."""

import sys
from pathlib import Path

import numpy as np
import pytest

import chip_smoke as cs
from infernos_tpu_torch.audio import speechlang as sl

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import speechlang as ref  # noqa: E402


@pytest.mark.parametrize("text,seed", [(ln[4], ln[5]) for ln in cs.CALL_LINES])
def test_call_speech_equals_tool(text, seed):
    rng, rng_ref = np.random.default_rng(seed), np.random.default_rng(seed)
    got = sl.render_text(rng, text, sl.Speaker.random(rng))
    want = ref.render_text(rng_ref, text, ref.Speaker.random(rng_ref))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 11])
def test_drawn_speaker_and_noise_equal_tool(seed):
    text = "want help today 42 ok"  # digits are not letters: skipped by both
    got = sl.render_text(np.random.default_rng(seed), text)
    want = ref.render_text(np.random.default_rng(seed), text)
    np.testing.assert_array_equal(got, want)
    assert sl.render_text(np.random.default_rng(seed), "  ").shape == (sl.SR // 10,)


def test_letter_code_equals_tool():
    assert sl.ALPHABET == ref.ALPHABET and sl.SR == ref.SR
    assert [sl.letter_formants(c) for c in sl.ALPHABET] == \
        [ref.letter_formants(c) for c in ref.ALPHABET]
    assert (sl.LETTER_DUR, sl.LETTER_GAP, sl.WORD_GAP) == \
        (ref.LETTER_DUR, ref.LETTER_GAP, ref.WORD_GAP)


# -- the benches' inputs: corpus, intents, pseudo-speech, far-end frames ------

def test_corpus_equals_tool():
    assert sl.EN_WORDS == ref.EN_WORDS
    assert sl.PT_WORDS == ref.PT_WORDS and sl.WORDS == ref.WORDS
    for name in ("tiny_stt", "tiny_tts", "tiny_llm"):
        assert sl.checkpoint_words(name) == ref.checkpoint_words(name)
    for n, seed, words in ((4, 555, None), (3, 556, sl.PT_WORDS), (8, 0, sl.EN_WORDS)):
        assert sl.transcript_corpus(n, seed=seed, words=words) == \
            ref.transcript_corpus(n, seed=seed, words=words)


def test_checkpoint_words_read_the_port_data_path(monkeypatch, tmp_path):
    """Without a corpus file the checkpoint means the English corpus; with
    ``INFERNOS_TINY_DATA_TINY_STT`` the port reads the named directory."""
    monkeypatch.setenv("INFERNOS_TINY_DATA_TINY_STT", str(tmp_path))
    assert sl.checkpoint_words("tiny_stt") == sl.EN_WORDS
    (tmp_path / "corpus.json").write_text('{"words": ["um", "dois"]}')
    assert sl.checkpoint_words("tiny_stt") == ["um", "dois"]


@pytest.mark.parametrize("seed", [0, 3, 17])
def test_make_utterance_equals_tool(seed):
    for lang in (None, "en", "pt"):
        got = sl.make_utterance(np.random.default_rng(seed), lang=lang)
        want = ref.make_utterance(np.random.default_rng(seed), lang=lang)
        assert got[1] == want[1]
        np.testing.assert_array_equal(got[0], want[0])


def test_intent_utterance_equals_trainer():
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from tools.train_tiny_llm import DEPTS, DIGITS, _intent_utterance

    assert (sl.DIGITS, sl.DEPTS) == (DIGITS, DEPTS)
    rng, rng_ref = np.random.default_rng(9), np.random.default_rng(9)
    got = [sl.intent_utterance(rng) for _ in range(64)]
    assert got == [_intent_utterance(rng_ref) for _ in range(64)]
    assert len(set(got)) >= 8  # every kind of line came up


@pytest.mark.parametrize("seed", [0, 5])
def test_synth_speech_equals_tool(seed):
    from infernos_tpu_torch.audio import synth_speech as ss
    from synth_speech import synth_speech

    for seconds in (1.6, 3.0):
        got = ss.synth_speech(np.random.default_rng(seed), seconds)
        want = synth_speech(np.random.default_rng(seed), seconds)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("seed", [0, 1, 42])
def test_bench_utterances_and_frames_equal_reference(seed):
    """What the port's LT bench speaks and streams equals the reference
    bench's: the pseudo-speech utterance, the speech-language line of the
    tiny-real mode, and the G.711 frames the fleet pre-encodes."""
    from infernos_tpu.audio.codecs import G711Codec as RefG711
    from infernos_tpu.bench import ltbench as ref_lt

    from infernos_tpu_torch.audio.codecs import G711Codec
    from infernos_tpu_torch.bench import ltbench

    a = ltbench._utterance(np.random.default_rng(seed), 1.6)
    np.testing.assert_array_equal(a, ref_lt._utterance(np.random.default_rng(seed), 1.6))
    b = ltbench.speechlang_utterance(np.random.default_rng(seed))
    np.testing.assert_array_equal(
        b, ref_lt.speechlang_utterance(np.random.default_rng(seed)))
    assert a.dtype == b.dtype == np.float32
    for audio in (a, b):
        frames = ltbench._encode_frames(G711Codec(), audio)
        assert frames == ref_lt._encode_frames(RefG711(), audio)
        assert len(frames) == len(audio) // 160 and {len(f) for f in frames} == {160}
