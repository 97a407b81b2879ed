"""The port's engine benches on the CPU: ``bench/sttbench.py``,
``bench/ttsbench.py``, ``bench/ttsprobe.py`` and ``bench/llmbench.py``.

- ``make_g711_corpus`` gives the reference's bytes for the same seed;
- ``sttbench.run_bench`` drives a tiny engine over a corpus to the end;
- port copies of ``tests/test_bench_ckpt.py``'s two ``ttsbench`` cases;
- ``ttsprobe.run_mode`` at tiny dims, and its refusal of the XLA modes;
- ``llmbench`` at ``--dims tiny`` with K 8 and with ``--spec``, giving the
  reference's JSON keys.
"""

import json

import pytest
import torch

from infernos_tpu.bench import sttbench as ref_sttbench
from infernos_tpu_torch.bench import llmbench, sttbench, ttsbench, ttsprobe
from infernos_tpu_torch.models import hifigan as hfg
from infernos_tpu_torch.models import presets
from infernos_tpu_torch.models import speecht5 as st5
from infernos_tpu_torch.serving.tts_engine import TTSEngine, TTSEngineConfig


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n,seed", [(3, 42), (5, 7)])
def test_g711_corpus_is_the_reference_bytes(n, seed):
    assert sttbench.make_g711_corpus(n=n, seed=seed) == \
        ref_sttbench.make_g711_corpus(n=n, seed=seed)


def test_sttbench_runs_a_tiny_engine_to_the_end():
    eng = sttbench.build_engine("cpu", full=False)
    corpus = sttbench.make_g711_corpus(n=6, min_s=0.5, max_s=3.0)
    r = sttbench.run_bench(eng, corpus)
    assert r["utterances"] == 6
    assert eng.n_active == 0 and len(eng.encode_ms) == 6
    assert r["audio_s"] > 0 and r["wall_s"] > 0
    assert r["realtime_factor"] == pytest.approx(r["audio_s"] / r["wall_s"], rel=0.05)
    assert 0 < r["inf_p50_s"] <= r["inf_p95_s"]


def _tts_engine(seed=0):
    cfg, voc = presets.SPEECHT5_TINY, presets.HIFIGAN_TINY
    g = torch.Generator().manual_seed(seed)
    return TTSEngine(
        st5.init_params(cfg, g, "cpu"), cfg, hfg.init_params(voc, g, "cpu"), voc,
        TTSEngineConfig(batch_slots=4, max_text_tokens=64, max_steps=24,
                        chunk_schedule=(8, 16), stop_threshold=2.0),
        device="cpu")


def test_ttsbench_reports():
    reps = ttsbench.run_bench(n_sessions=6, engine=_tts_engine(), max_frames=32)
    assert len(reps) == 6
    for r in reps:
        assert r.frames >= 0
        assert r.time_to_first_frame <= r.time_to_last_frame
        assert r.rtr > 0
    s = ttsbench.summarize(reps)
    assert s["sessions"] == 6
    assert s["ttff_p50"] <= s["ttff_p95"]


def test_ttsbench_deterministic_frames():
    a = ttsbench.run_bench(n_sessions=4, engine=_tts_engine(seed=1), max_frames=32)
    b = ttsbench.run_bench(n_sessions=4, engine=_tts_engine(seed=1), max_frames=32)
    assert [r.frames for r in a] == [r.frames for r in b]


def test_ttsbench_builds_its_own_seeded_engine():
    reps = ttsbench.run_bench(n_sessions=3, tiny=True, max_frames=16, device="cpu")
    assert [r.session for r in reps] == [0, 1, 2]
    assert all(r.frames > 0 for r in reps)


def test_ttsprobe_times_ticks_at_tiny_dims():
    out = ttsprobe.run_mode(4, 3, 32, device="cpu", tiny=True)
    assert set(out) == {"tick_p50_ms", "tick_p95_ms", "compile_s"}
    assert 0 < out["tick_p50_ms"] <= out["tick_p95_ms"]


@pytest.mark.parametrize("only", ["xla", "both"])
def test_ttsprobe_refuses_the_xla_modes(only, capsys):
    with pytest.raises(SystemExit) as e:
        ttsprobe.main(["--only", only])
    assert e.value.code == 2
    assert "no plain step on the card" in capsys.readouterr().err


# the reference's keys (infernos_tpu/bench/llmbench.py, ``out``)
REF_KEYS = {"metric", "value", "unit", "detail"}
REF_DETAIL_KEYS = {"platform", "requests", "new_tokens_each", "prompt_tokens",
                   "gen_p50_s", "gen_p95_s", "compile_s", "spec_emit_mean", "wall_s"}


@pytest.mark.parametrize("mode", [["--steps-per-dispatch", "8"], ["--spec"]],
                         ids=["k8", "spec"])
def test_llmbench_tiny_gives_the_reference_keys(mode, monkeypatch, capsys):
    monkeypatch.setenv("INFERNOS_DEVICE", "cpu")
    llmbench.main(["--dims", "tiny", "--slots", "4", "--new", "12", "--reqs", "6",
                   "--prompt", "32"] + mode)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert REF_KEYS <= set(out) and REF_DETAIL_KEYS <= set(out["detail"])
    d = out["detail"]
    assert out["metric"] == "llm_decode_tok_per_s" and out["value"] > 0
    assert d["platform"] == "cpu" and d["requests"] == 6 and d["finished"] == 6
    assert d["tokens"] == 6 * 12  # zero weights never reach EOS
    assert d["gen_p50_s"] <= d["gen_p95_s"]
    if "--spec" in mode:
        assert "spec" in out["unit"] and d["spec_emit_mean"] > 0
    else:
        assert "K=8" in out["unit"]
