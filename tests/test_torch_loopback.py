"""Loopback QA (``infernos_tpu_torch.bench.loopback``) against the
reference's (``infernos_tpu/bench/loopback.py``) on the trained tiny-real
pair, fp32, CPU.

The port's TTS runs on the reference's draws (``torch_reference_draws``:
prenet dropout masks and the Griffin-Lim phase), so each (voice, prompt)
cell must come back with the reference's transcript and similarity.  The
reference's mean over the cells that ``chip_smoke.py``'s ``loopback`` phase
scores on the card (4 voices x 2 prompts) is that phase's bar, less 0.1:
``chip_smoke.LOOPBACK_REF_MEAN`` must be that mean.
"""

import json

import numpy as np
import pytest
import torch

import chip_smoke as cs
from infernos_tpu_torch.bench import loopback
from infernos_tpu_torch.models import tiny_real

from torch_reference_draws import reference_draws  # noqa: F401  (fixture)

pytestmark = pytest.mark.skipif(
    not (tiny_real.have_tiny_stt() and tiny_real.have_tiny_tts()),
    reason="the vendored tiny-real pair is not present")

VOICES = 4
PROMPTS = 2


class _Bank:
    def __init__(self, table):
        self.table = table

    def get(self, sid):
        return self.table[sid % len(self.table)]


@pytest.fixture(scope="module")
def reference_cells():
    """The reference LoopbackQA's cells over VOICES x PROMPTS, and its prompts."""
    import sys
    from pathlib import Path

    from infernos_tpu.bench.loopback import LoopbackQA
    from infernos_tpu.models import tiny_real as ref_tr
    from infernos_tpu.serving.stt_engine import STTEngine
    from infernos_tpu.serving.tts_engine import TTSEngine, TTSEngineConfig

    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
    import speechlang as ref_sl

    # the prompts the reference's main builds for --prompts 2
    ck = set(ref_sl.checkpoint_words("tiny_stt"))
    en = [w for w in ref_sl.EN_WORDS if w in ck]
    pt = [w for w in ref_sl.PT_WORDS if w in ck and w not in en]
    prompts = ([(t, "en") for t in ref_sl.transcript_corpus(1, seed=555, words=en)]
               + [(t, "pt") for t in ref_sl.transcript_corpus(1, seed=556, words=pt)])
    t5, tcfg, voc, vcfg, ttok, table = ref_tr.load_tiny_tts()
    sparams, scfg, stok, secfg = ref_tr.load_tiny_stt()
    tts = TTSEngine(t5, tcfg, voc, vcfg, TTSEngineConfig(
        batch_slots=4, max_text_tokens=48, max_steps=170, stop_threshold=0.5))
    stt = STTEngine(sparams, scfg, secfg, detokenize=stok.detokenize)
    qa = LoopbackQA(tts, stt, tokenize=ttok)
    cells = qa.run_bank(_Bank(table), list(range(VOICES)), prompts)
    return prompts, {sid: [(r.transcript, r.similarity) for r in rows]
                     for sid, rows in cells.items()}


@pytest.fixture
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_prompts_equal_reference(reference_cells):
    prompts, _ = reference_cells
    assert loopback.loopback_prompts(PROMPTS) == prompts
    assert [lang for _, lang in prompts] == ["en", "pt"]


def test_text_similarity_equals_reference():
    from infernos_tpu.bench.loopback import text_similarity as ref_sim

    for a, b in (("please help now", "please help now"),
                 ("please help now", "pleas hel nw"), ("Favor", "favor ajuda"),
                 ("", "x"), ("abc", "")):
        assert loopback.text_similarity(a, b) == ref_sim(a, b)


def test_loopback_cells_equal_reference(reference_cells, reference_draws, two_threads):
    """Every (voice, prompt) cell: the port's transcript and similarity are
    the reference's, on the reference's TTS draws; and the reference's mean
    over the cells is the card phase's recorded one."""
    prompts, ref = reference_cells
    tts, stt, ttok, table = loopback.tiny_real_engines("cpu")
    assert tts.ecfg.dtype == torch.float32
    qa = loopback.LoopbackQA(tts, stt, tokenize=ttok)
    got = qa.run_bank(_Bank(table), list(range(VOICES)), prompts)
    got = {sid: [(r.transcript, r.similarity) for r in rows] for sid, rows in got.items()}
    assert got == ref
    ref_mean = float(np.mean([s for rows in ref.values() for _, s in rows]))
    assert ref_mean == pytest.approx(cs.LOOPBACK_REF_MEAN, abs=5e-4)
    assert qa.scores == {sid: pytest.approx(np.mean([s for _, s in rows]))
                         for sid, rows in ref.items()}


def test_loopback_main_resumes_from_its_checkpoint(tmp_path, monkeypatch, capsys,
                                                   two_threads):
    """``main`` on the CPU writes each (voice, prompt) cell to its
    checkpoint; a second run reads every cell back and scores nothing
    again (its engines are never stepped), with the same result."""
    ckpt = tmp_path / "cells.json"
    monkeypatch.setenv("INFERNOS_DEVICE", "cpu")
    argv = ["--speakers", "2", "--prompts", "2", "--checkpoint", str(ckpt)]
    loopback.main(argv)
    first = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    cells = json.loads(ckpt.read_text())
    assert sorted(k for k in cells if ":" in k) == ["0:0", "0:1", "1:0", "1:1"]
    assert "__fingerprint__" in cells and first["detail"]["voices_scored"] == 2

    def never(*a, **kw):
        raise AssertionError("a resumed cell was scored again")

    monkeypatch.setattr(loopback.LoopbackQA, "score_speaker", never)
    loopback.main(argv)
    second = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert second["value"] == first["value"]
    assert second["detail"]["per_voice_mean_distribution"] == \
        first["detail"]["per_voice_mean_distribution"]
    assert second["detail"]["samples"] == first["detail"]["samples"]

    # a checkpoint scored against other weights or prompts is discarded
    cells["__fingerprint__"] = "other"
    ckpt.write_text(json.dumps(cells))
    with pytest.raises(AssertionError, match="scored again"):
        loopback.main(argv)
