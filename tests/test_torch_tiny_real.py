"""Tiny-real on the port's own loaders and tokenizers, against the JAX package.

- Copies of ``tests/test_tokenizers.py`` on the port's ``models/bpe.py`` and
  ``models/spm.py`` (the HF and SentencePiece cases skip as the originals
  do when their libraries are missing; the HF case calls the HF tokenizer
  directly, since the port has no ``HFTokenizerAdapter`` yet);
- the port's BPE and SentencePiece give the JAX package's token ids on every
  word and sentence of the vendored tiny corpora, and the same
  ``detokenize``;
- ``load_tiny_stt`` / ``load_tiny_tts`` on the CPU return, leaf for leaf,
  the trees ``from_jax_params`` makes of the JAX loaders' trees, and the
  same configs, specials and speaker table; the trio is fp32 on every
  device, and only a full-width engine is bf16, on the card only
  (``serving_dtype``).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax

from infernos_tpu.models import bpe as jbpe
from infernos_tpu.models import spm as jspm
from infernos_tpu.models import tiny_real as jtr
from infernos_tpu_torch.models import tiny_real
from infernos_tpu_torch.models.bpe import (ByteLevelBPE, bytes_to_unicode,
                                           train_bpe)
from infernos_tpu_torch.models.convert import from_jax_params
from infernos_tpu_torch.models.npz_io import data_path
from infernos_tpu_torch.models.spm import (SentencePieceModel, load_spm_model,
                                           save_spm_model, train_char_spm)


# -- copies of tests/test_tokenizers.py ----------------------------------------------

def test_bytes_to_unicode_reversible():
    m = bytes_to_unicode()
    assert len(m) == 256
    assert len(set(m.values())) == 256
    # printable ascii maps to itself
    assert m[ord("a")] == "a"
    assert m[ord("!")] == "!"


def _toy_bpe():
    """Hand-built table: bytes + merges for 'he', 'll', 'hell', 'hello'."""
    vocab = {u: i for i, u in enumerate(
        sorted(bytes_to_unicode().values(),
               key=lambda u: [k for k, v in bytes_to_unicode().items()
                              if v == u][0]))}
    # ^ byte alphabet in byte order
    merges = [("h", "e"), ("l", "l"), ("he", "ll"), ("hell", "o")]
    for a, b in merges:
        vocab[a + b] = len(vocab)
    return ByteLevelBPE(vocab, merges)


def test_bpe_golden_merges():
    tok = _toy_bpe()
    ids = tok.encode("hello")
    assert [tok.id_to_tok[i] for i in ids] == ["hello"]
    ids = tok.encode("hell")
    assert [tok.id_to_tok[i] for i in ids] == ["hell"]
    ids = tok.encode("he ll")
    # " ll" has a leading space byte token (Ġ) so 'll' merge applies after
    toks = [tok.id_to_tok[i] for i in ids]
    assert toks[0] == "he"
    assert "".join(toks).endswith("ll")


def test_bpe_roundtrip_unicode():
    tok = _toy_bpe()
    for text in ["hello world", "héllo", "日本語 text", "a\nb\tc",
                 "  spaces  ", "don't stop"]:
        assert tok.decode(tok.encode(text)) == text


def test_bpe_special_tokens():
    vocab = {u: i for i, u in enumerate(bytes_to_unicode().values())}
    tok = ByteLevelBPE(vocab, [], special_tokens={"<|eos|>": 500})
    ids = tok.encode("hi<|eos|>yo")
    assert 500 in ids
    assert tok.decode(ids) == "hiyo"  # specials skipped
    assert tok.decode(ids, skip_special=False) == "hi<|eos|>yo"


def test_bpe_trainer_learns_merges_and_roundtrips():
    corpus = ["the cat sat on the mat"] * 50 + ["the dog ran"] * 30
    tok = train_bpe(corpus, vocab_size=300, special_tokens=["<pad>"])
    assert tok.ranks, "trainer produced no merges"
    # frequent word 'the' should become few tokens
    assert len(tok.encode("the")) <= 2
    for text in corpus[:1] + ["unseen words zqx"]:
        assert tok.decode(tok.encode(text)) == text
    assert tok.special["<pad>"] == tok.vocab_size - 1


def test_bpe_file_roundtrip(tmp_path):
    tok = train_bpe(["aa bb aa bb cc"] * 20, vocab_size=280)
    vj, mt = str(tmp_path / "vocab.json"), str(tmp_path / "merges.txt")
    tok.save(vj, mt)
    tok2 = ByteLevelBPE.from_files(vj, mt)
    text = "aa bb cc dd"
    assert tok2.encode(text) == tok.encode(text)
    assert tok2.decode(tok2.encode(text)) == text


def test_bpe_matches_hf_gpt2_fast(tmp_path):
    """The port's engine against HF's tokenizers on the SAME on-disk
    vocab/merges: a checkpoint port is data-only."""
    transformers = pytest.importorskip("transformers")
    tok = train_bpe(
        ["the quick brown fox jumps over the lazy dog"] * 40
        + ["pack my box with five dozen liquor jugs"] * 25,
        vocab_size=330)
    vj, mt = str(tmp_path / "vocab.json"), str(tmp_path / "merges.txt")
    tok.save(vj, mt)
    try:
        hf = transformers.GPT2TokenizerFast(vocab_file=vj, merges_file=mt)
    except Exception as e:  # tokenizers backend unavailable offline
        pytest.skip(f"GPT2TokenizerFast unavailable: {e}")
    for text in ["the quick brown fox", "lazy dogs jump", "a!b? c,d.",
                 "hello unseen tokens"]:
        ours = tok.encode(text)
        theirs = list(hf(text, add_special_tokens=False)["input_ids"])
        assert ours == theirs, (text, ours, theirs)
        assert hf.decode(theirs, skip_special_tokens=True) == tok.decode(ours) == text


def test_spm_char_train_encode_decode():
    corpus = ["hello world", "how are you"]
    m = train_char_spm(corpus)
    ids = m.encode("hello you")
    assert m.decode(ids) == "hello you"
    # encode maps known chars to non-unk pieces
    assert all(i != m.unk_id for i in ids)
    # unknown char falls back to unk
    ids2 = m.encode("hello Z")
    assert m.unk_id in ids2


def test_spm_viterbi_prefers_longer_pieces():
    # piece table where 'ab' has better score than 'a'+'b'
    pieces = [("<unk>", -10.0, 2), ("a", -3.0, 1), ("b", -3.0, 1),
              ("ab", -2.0, 1), ("▁", -1.0, 1)]
    m = SentencePieceModel(pieces)
    ids = m.encode("ab", add_ws_prefix=False)
    assert [m.pieces[i][0] for i in ids] == ["ab"]


def test_spm_protobuf_roundtrip(tmp_path):
    m = train_char_spm(["round trip text"])
    path = str(tmp_path / "spiece.model")
    save_spm_model(m, path)
    m2 = load_spm_model(path)
    assert len(m2.pieces) == len(m.pieces)
    for (p1, s1, t1), (p2, s2, t2) in zip(m.pieces, m2.pieces):
        assert p1 == p2 and t1 == t2
        assert abs(s1 - s2) < 1e-6
    text = "round trip"
    assert m2.decode(m2.encode(text)) == text
    assert m2.encode(text) == m.encode(text)


def test_spm_matches_real_sentencepiece_if_available(tmp_path):
    """If the sentencepiece lib is importable, cross-check decode parity
    on the port's own serialized model."""
    spm_lib = pytest.importorskip("sentencepiece")
    m = train_char_spm(["cross check text here"])
    path = str(tmp_path / "spiece.model")
    save_spm_model(m, path)
    try:
        sp = spm_lib.SentencePieceProcessor(model_file=path)
    except Exception as e:
        pytest.skip(f"sentencepiece refused minimal model: {e}")
    ids = m.encode("check text")
    assert sp.decode(ids) == m.decode(ids)


# -- the vendored tokenizers against the JAX package's -------------------------------

def _corpus(name):
    with open(os.path.join(data_path(name), "corpus.json")) as f:
        words = json.load(f)["words"]
    rng = np.random.default_rng(0)  # sentences of 1-6 corpus words
    sentences = [" ".join(rng.choice(words, int(rng.integers(1, 7))))
                 for _ in range(64)]
    return words, sentences + ["please help now", "quero ajuda hoje",
                               "favor ajuda agora", "want help today"]


def _stt_tokenizers():
    d = data_path("tiny_stt")
    with open(os.path.join(d, "special_tokens.json")) as f:
        specials = json.load(f)
    files = (os.path.join(d, "tokenizer", "vocab.json"),
             os.path.join(d, "tokenizer", "merges.txt"))
    return (ByteLevelBPE.from_files(*files, special_tokens=specials),
            jbpe.ByteLevelBPE.from_files(*files, special_tokens=specials), specials)


@pytest.mark.parametrize("corpus", ["tiny_stt", "tiny_tts"])
def test_bpe_ids_and_detokenize_match_jax_on_the_corpus(corpus):
    tok, jtok, specials = _stt_tokenizers()
    words, sentences = _corpus(corpus)
    n = 0
    for text in words + sentences:
        ids = tok.encode(text)
        assert ids == jtok.encode(text), text
        assert np.array_equal(tok(text), jtok(text))
        assert tok.detokenize(ids) == jtok.detokenize(ids) == text
        # with the decode's specials around it, as the engine hands them over
        framed = [specials["<|sot|>"], *ids, specials["<|eos|>"]]
        assert tok.detokenize(framed) == jtok.detokenize(framed)
        assert tok.decode(framed, skip_special=False) == \
            jtok.decode(framed, skip_special=False)
        n += 1
    assert n > 100


@pytest.mark.parametrize("corpus", ["tiny_stt", "tiny_tts"])
def test_spm_ids_and_detokenize_match_jax_on_the_corpus(corpus):
    path = os.path.join(data_path("tiny_tts"), "tokenizer", "spiece.model")
    tok, jtok = load_spm_model(path), jspm.load_spm_model(path)
    assert tok.pieces == jtok.pieces
    words, sentences = _corpus(corpus)
    for text in words + sentences:
        ids = tok.encode(text)
        assert ids == jtok.encode(text), text
        assert np.array_equal(tok(text), jtok(text))
        assert tok.detokenize(ids) == jtok.detokenize(ids)
        assert tok.decode(ids) == jtok.decode(ids)


# -- the loaders ---------------------------------------------------------------------

def _assert_same_tree(got, want, path="params"):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same_tree(g, w, f"{path}[{i}]")
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert torch.equal(got, want), path


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _same_fields(got, want):
    for f in dataclasses.fields(got):
        if hasattr(want, f.name):
            assert getattr(got, f.name) == getattr(want, f.name), f.name


def test_load_tiny_stt_equals_the_jax_loader():
    params, cfg, tok, ecfg = tiny_real.load_tiny_stt(device="cpu")
    jparams, jcfg, jtok, jecfg = jtr.load_tiny_stt()
    _assert_same_tree(params, from_jax_params(_np(jparams), "cpu"))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert ecfg.dtype == torch.float32
    for f in dataclasses.fields(ecfg):
        if f.name != "dtype" and hasattr(jecfg, f.name):
            want = getattr(jecfg, f.name)
            got = getattr(ecfg, f.name)
            assert got == want or tuple(got) == tuple(want), f.name
    assert tok.special == jtok.special and tok.vocab_size == jtok.vocab_size


@pytest.mark.parametrize("vocoder", ["gl", "hifigan"])
def test_load_tiny_tts_equals_the_jax_loader(vocoder):
    params, cfg, vp, vcfg, tok, table = tiny_real.load_tiny_tts(vocoder, device="cpu")
    jparams, jcfg, jvp, jvcfg, jtok, jtable = jtr.load_tiny_tts(vocoder)
    _assert_same_tree(params, from_jax_params(_np(jparams), "cpu"))
    _assert_same_tree(vp, from_jax_params(_np(jvp), "cpu"))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(vcfg) == dataclasses.asdict(jvcfg)
    assert type(vcfg).__name__ == type(jvcfg).__name__
    np.testing.assert_array_equal(table, jtable)
    assert tok.pieces == jtok.pieces


def test_tts_vocoder_default_follows_the_environment(monkeypatch):
    monkeypatch.delenv("INFERNOS_TTS_VOCODER", raising=False)
    assert type(tiny_real.load_tiny_tts(device="cpu")[3]).__name__ == "GriffinLimConfig"
    monkeypatch.setenv("INFERNOS_TTS_VOCODER", "hifigan")
    assert type(tiny_real.load_tiny_tts(device="cpu")[3]).__name__ == "HifiGanConfig"


def test_serving_dtype_is_bf16_on_the_card_only():
    """bf16 only for a full-width engine on the card; the tiny and tiny-real
    engines are fp32 on every device, as the reference serves them."""
    assert tiny_real.serving_dtype("cpu", tiny=False) == torch.float32
    assert tiny_real.serving_dtype(torch.device("cuda"), tiny=False) == torch.bfloat16
    for dev in ("cpu", torch.device("cuda")):
        assert tiny_real.serving_dtype(dev, tiny=True) == torch.float32
    assert tiny_real.have_tiny_stt() and tiny_real.have_tiny_tts()
