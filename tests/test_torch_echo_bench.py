"""The echo-loop bench (``bench/echo.py``) on the port: a copy of
``tests/test_echo_bench.py::test_echo_loop_round_trip``, RTP -> VAD -> STT
-> TTS -> RTP through the port's actors with tiny random models on the CPU.
Its RTP ports are 39800-40100; no other test file uses them.

What differs from the reference's case: the caller waits up to 60 s after
the last gap for the loop's answers (``echo.SETTLE_S``) instead of ending
the call when the gap ends, and torch runs one intra-op thread.  On a loaded
host the reference's copy reported no echo at all (the loop answered after
the call had ended); every assertion, the 2.5 s bound on the last echo
included, is the reference's.
"""

import pytest
import torch

from infernos_tpu_torch.bench import echo
from infernos_tpu_torch.bench.echo import run_echo
from infernos_tpu_torch.cluster.actors import stop_all


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.e2e
def test_echo_loop_round_trip():
    try:
        rep = run_echo(tiny=True, utterances=2, speech_s=1.0, gap_s=2.5,
                       device="cpu", rtp_ports=(39800, 40100))
    finally:
        stop_all()
    # every utterance produced an STT result and echoed audio came back
    assert len(rep.stt_latency_s) == 2, rep
    assert len(rep.echo_latency_s) >= 1, rep
    assert rep.rx_audio_s > 0.1
    # latency sanity: steady-state turns complete within the silence gap
    assert all(t > 0.0 for t in rep.echo_latency_s), rep.echo_latency_s
    assert rep.echo_latency_s[-1] < 2.5, rep.echo_latency_s


def test_echo_main_refuses_tiny_random_on_a_card(monkeypatch):
    class Past(Exception):
        pass

    def stub(*a, **kw):
        raise Past

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.delenv("INFERNOS_DEVICE", raising=False)
    monkeypatch.setenv("INFERNOS_MODEL_MODE", "")
    monkeypatch.setattr(echo, "run_echo", stub)
    with pytest.raises(SystemExit) as e:
        echo.main([])
    assert e.value.code == 2
    with pytest.raises(Past):
        echo.main(["--tiny-real"])
