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
