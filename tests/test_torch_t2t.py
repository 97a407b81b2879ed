"""The port's copies of the host-side text modules give the originals'
outputs, string for string (``infernos_tpu_torch/t2t`` vs ``infernos_tpu/t2t``).
"""

import pytest

from infernos_tpu import t2t as jt2t
from infernos_tpu.t2t import lexicon as jlex
from infernos_tpu.t2t import translator as jtr
from infernos_tpu_torch import t2t
from infernos_tpu_torch.t2t import lexicon as lex
from infernos_tpu_torch.t2t import translator as tr

TEXTS = [
    "Hello. How are you? I am fine!",
    "Dr. Smith arrived at 3 p.m. He left at 5.",
    "one two three",
    "help me now, please",
    "The bill is 1,250 and the tip is 15%.",
    "Call 911 now! It costs 20 today.",
    "no punctuation at all just words going on and on " * 4,
    "First sentence is short. " + "Second sentence is quite a lot longer than the first one, "
    "going on for a while. " * 3 + "Third.",
    "",
    "   ",
    "E.g. this works, i.e. it splits. Inc. is an abbreviation. No. 5 is not.",
    "A. B. C. Single letters stay together.",
]


@pytest.mark.parametrize("text", TEXTS, ids=range(len(TEXTS)))
def test_sent_split_and_regroup_identical(text):
    want = jt2t.sent_split(text)
    assert t2t.sent_split(text) == want
    for max_chars in (16, 64, 128):
        assert t2t.regroup_sentences(want, max_chars) == \
            jt2t.regroup_sentences(want, max_chars)


NUMBERS = ["I have 3 cats.", "It costs 1,250 dollars", "15% of 200 is 30",
           "room 101, floor 7!", "no digits here", "year 2024 and 1000000",
           "0 and 13 and 40 and 99", "a 3.5 ratio"]


@pytest.mark.parametrize("text", NUMBERS, ids=range(len(NUMBERS)))
@pytest.mark.parametrize("lang", ["en", "pt"])
def test_numbers_to_words_identical(text, lang):
    tr_fn = (lambda w: f"<{w}>") if lang != "en" else None
    assert t2t.NumbersToWords(lang, tr_fn)(text) == jt2t.NumbersToWords(lang, tr_fn)(text)


PHRASES = ["one two three", "Help me now", "GOOD morning, friend!",
           "the red house is big.", "unknownword stays (here)", "", "Yes? No!"]


@pytest.mark.parametrize("text", PHRASES, ids=range(len(PHRASES)))
@pytest.mark.parametrize("pair", [("en", "pt"), ("pt", "en"), ("en", "es"),
                                  ("pt", "fr")], ids="-".join)
def test_lexicon_translator_identical(text, pair):
    want = jtr.Translator(*pair, backend=jlex.LexiconBackend()).translate(text)
    assert tr.Translator(*pair, backend=lex.LexiconBackend()).translate(text) == want
    back = jtr.Translator(*pair[::-1], backend=jlex.LexiconBackend()).translate(want)
    assert tr.Translator(*pair[::-1], backend=lex.LexiconBackend()).translate(want) == back


def test_lexicon_tables_identical():
    assert lex.EN_PT == jlex.EN_PT and lex.PT_EN == jlex.PT_EN
    assert tr.SUPPORTED_LANGS == jtr.SUPPORTED_LANGS
    assert lex.LexiconBackend().pairs() == jlex.LexiconBackend().pairs()


def test_translator_pivot_filter_and_cache_identical():
    class Two:
        def pairs(self):
            return [("en", "it"), ("it", "de")]

        def translate(self, text, a, b):
            return f"{text}|{a}>{b}"

    calls = []

    def filt(t, from_code, to_code, tr):
        calls.append((from_code, to_code))
        return tr(t.upper())

    for mod in (tr, jtr):
        calls.clear()
        t = mod.Translator("en", "de", backend=Two(), filter=filt)
        assert t.translate("x") == "X|EN>IT|it>de"
        assert calls == [("en", "it"), ("it", "de")]
        with pytest.raises(ValueError, match="no translation path"):
            mod.Translator("de", "en", backend=Two())
        assert mod.get_translator("en", "pt") is mod.get_translator("en", "pt")
        llm = mod.LLMBackend(lambda prompt: f" [{prompt[:9]}] ")
        assert llm.translate("hi", "en", "pt") == "[Translate]"
    assert tr.EchoBackend().translate("a", "en", "pt") == \
        jtr.EchoBackend().translate("a", "en", "pt")
