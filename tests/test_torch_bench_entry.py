"""The flagship bench entry (``python -m infernos_tpu_torch.bench``): its
capped child runs, the result line it takes from each child and the
headline it publishes, on the CPU with stub children where a bench would
need the card."""

import json
import sys
import time

import pytest
import torch

import infernos_tpu_torch.bench.__main__ as flagship


def test_run_capped_kills_a_child_past_its_cap_and_keeps_its_output(capsys):
    code = ("import sys, time\n"
            "print('{\"level\": 1}', flush=True)\n"
            "print('still going', file=sys.stderr, flush=True)\n"
            "time.sleep(120)\n"
            "print('{\"level\": 2}', flush=True)\n")
    t0 = time.monotonic()
    out, err, rc = flagship._run_capped([sys.executable, "-c", code], None, timeout=3,
                                        publish_progress=True)
    assert time.monotonic() - t0 < 30
    assert rc is not None and rc < 0  # killed by a signal
    assert flagship._last_json_line(out) == {"level": 1}
    assert "still going" in err
    # the child's freshest line was published while it ran
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == {"level": 1}


def test_run_capped_returns_a_finished_child_at_once():
    t0 = time.monotonic()
    out, err, rc = flagship._run_capped(
        [sys.executable, "-c", "print('{\"ok\": true}')"], None, timeout=60)
    assert (rc, flagship._last_json_line(out), err) == (0, {"ok": True}, "")
    assert time.monotonic() - t0 < 30


def test_last_json_line_takes_the_last_parseable_line():
    text = '{"a": 1}\nnoise\n  {"b": 2}  \n{"c": \nnot json {"d": 4}\n\n'
    assert flagship._last_json_line(text) == {"b": 2}
    assert flagship._last_json_line("no json here\n{broken") is None
    assert flagship._last_json_line("") is None


def test_run_prints_a_failed_childs_stderr_tail(capsys):
    code = "import sys; sys.stderr.write('x' * 9000 + 'the cause'); sys.exit(3)"
    result, rc = flagship._run(["-c", code], timeout=60)
    assert (result, rc) == (None, 3)
    err = capsys.readouterr().err
    assert err.count("x") <= flagship.STDERR_TAIL and "the cause" in err
    assert "exited 3" in err


LT = {"metric": "lt_calls_per_chip", "value": 4, "unit": "calls",
      "detail": {"turn_p95_s": 3.1}}
TTS = {"metric": "tts_paced_concurrent_calls_per_chip", "value": 120,
       "detail": {"platform": "gpu"}}
LOOPBACK = {"metric": "loopback_similarity", "value": 0.97,
            "detail": {"voices_scored": 32}, "unit": "ratio"}


def test_flagship_result_takes_the_lt_headline_above_zero():
    r = flagship.flagship_result(LT, TTS, LOOPBACK)
    assert (r["metric"], r["value"]) == ("lt_calls_per_chip", 4)
    assert r["detail"]["tts_paced"] == TTS and r["detail"]["turn_p95_s"] == 3.1
    assert r["detail"]["loopback_similarity"] == {"value": 0.97,
                                                  "detail": {"voices_scored": 32}}
    lt0 = dict(LT, value=0)
    r = flagship.flagship_result(lt0, TTS, None)
    assert (r["metric"], r["value"]) == (TTS["metric"], 120)
    assert r["detail"]["lt_ramp_attempt"] == lt0 and "loopback_similarity" not in r["detail"]
    r = flagship.flagship_result(None, TTS, None)
    assert r["value"] == 120 and r["detail"]["lt_ramp_attempt"] is None
    r = flagship.flagship_result(None, None, LOOPBACK)
    assert (r["metric"], r["value"]) == ("lt_calls_per_chip", 0)
    assert r["detail"]["error"] == "both benches failed"
    assert LT["detail"] == {"turn_p95_s": 3.1}  # the children's lines stay as they were


@pytest.mark.parametrize("lt_value", [4, 0])
def test_flagship_main_runs_the_three_benches_in_order(monkeypatch, capsys, lt_value):
    """With ``INFERNOS_DEVICE=cpu`` the flagship runs the LT ramp (with
    its slot and decode defaults), the TTS bench and loopback, and its last
    line is the headline; no line holds a figure from other hardware."""
    runs = []

    def run(args, env_extra=None, timeout=3600, publish_progress=False):
        runs.append((args[1], env_extra))
        return {"infernos_tpu_torch.bench.ltbench": dict(LT, value=lt_value),
                "infernos_tpu_torch.bench.ttsmain": TTS,
                "infernos_tpu_torch.bench.loopback": LOOPBACK}[args[1]], 0

    monkeypatch.setattr(flagship, "_run", run)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("INFERNOS_DEVICE", "cpu")
    for k in ("BENCH_LT", "BENCH_LOOPBACK", "INFERNOS_STT_MAX_NEW",
              "INFERNOS_TTS_SLOTS", "INFERNOS_STT_SLOTS"):
        monkeypatch.delenv(k, raising=False)
    flagship.main()
    assert [a for a, _ in runs] == ["infernos_tpu_torch.bench.ltbench",
                                    "infernos_tpu_torch.bench.ttsmain",
                                    "infernos_tpu_torch.bench.loopback"]
    assert runs[0][1] == {"INFERNOS_STT_MAX_NEW": "24", "INFERNOS_TTS_SLOTS": "32",
                          "INFERNOS_STT_SLOTS": "24"}
    lines = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]
    assert lines[0]["value"] == 0 and "interrupted" in lines[0]["detail"]["error"]
    assert lines[-1] == flagship.flagship_result(dict(LT, value=lt_value), TTS, LOOPBACK)
    for ln in lines:
        text = json.dumps(ln)
        for word in ("last_recorded_hardware", "vs_baseline", "v5e", "TPU", "tpu"):
            assert word not in text


def test_flagship_main_raises_without_a_card(monkeypatch):
    def run(*a, **kw):
        raise AssertionError("a bench was started")

    monkeypatch.setattr(flagship, "_run", run)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("INFERNOS_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flagship.main()


def test_child_failure_reaches_the_flagship_stderr(monkeypatch, capsys):
    """A bench child that fails: its standard error's tail is printed, and
    the flagship still ends on a result line."""
    real_run_capped = flagship._run_capped

    def run_capped(argv, env, timeout, publish_progress=False):
        code = "import sys; sys.stderr.write('Traceback: boom'); sys.exit(1)"
        return real_run_capped([sys.executable, "-c", code], env, timeout)

    monkeypatch.setattr(flagship, "_run_capped", run_capped)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("INFERNOS_DEVICE", "cpu")
    monkeypatch.setenv("BENCH_LOOPBACK", "0")
    flagship.main()
    captured = capsys.readouterr()
    assert captured.err.count("Traceback: boom") == 2  # the LT and TTS children
    last = json.loads(captured.out.strip().splitlines()[-1])
    assert last["value"] == 0 and last["detail"]["error"] == "both benches failed"


def test_children_run_from_the_checkout_root():
    """The children are ``python -m infernos_tpu_torch.bench.*`` run from
    the directory that holds the package."""
    from pathlib import Path

    assert (Path(flagship.REPO) / "infernos_tpu_torch" / "bench" / "__main__.py").is_file()
    out, _, rc = flagship._run_capped(
        [sys.executable, "-c", "import os; print(os.getcwd())"], None, timeout=60)
    assert rc == 0 and Path(out.strip()) == Path(flagship.REPO)
