"""The attendant multi-call bench (``bench/aiabench.py``) on the port: a
copy of ``tests/test_call_benches.py::test_aia_multi_call_bench`` over real
SIP and RTP on loopback into ``build_cluster(tiny=True, device="cpu")``
with tiny random STT, LLM and TTS.  Beside it, the bench's ``main``
refuses the tiny random models on a card.

Ports: SIP 25098, RTP 39500-39800; no other test file uses them.
"""

import textwrap

import pytest
import torch

from infernos_tpu_torch.bench import aiabench
from infernos_tpu_torch.bench.aiabench import run_aia_bench
from infernos_tpu_torch.cluster.actors import stop_all
from infernos_tpu_torch.config import InfernConfig
from infernos_tpu_torch.main import build_cluster


@pytest.fixture(autouse=True)
def _two_threads():
    """Few intra-op threads: the tiny models' ops are small, and a loaded
    CPU stalls a wide thread pool on its slowest thread every op."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.e2e
def test_aia_multi_call_bench(tmp_path):
    cfg_text = textwrap.dedent("""
        sip:
          settings:
            bind: 127.0.0.1:25098
          profiles:
            inbound:
              sink: apps/ai_attendant/bench
        rtp:
          settings:
            min_port: 39500
            max_port: 39800
        apps:
          ai_attendant:
            profiles:
              bench:
                stt_lang: en
                tts_lang: en
                llm_prompt: "You are a phone attendant. Be brief."
    """)
    p = tmp_path / "aia.yaml"
    p.write_text(cfg_text)
    iconf = InfernConfig(str(p))
    build_cluster(iconf, tiny=True, bind_ip="127.0.0.1", device="cpu")
    try:
        r = run_aia_bench(iconf.sip_conf.bind, n_calls=2, turns=1,
                          turn_timeout=90.0)
        assert r.answered == 2, r
        assert r.turns >= 1, r
        assert r.reply_p50_s < 60.0, r
    finally:
        stop_all()


class _PastTheDevice(Exception):
    pass


def test_aiabench_main_refuses_tiny_random_on_a_card(monkeypatch):
    """On a card ``main`` serves ``--full`` or ``--tiny-real``; the bare
    tiny mode is a usage error before any actor starts."""
    def stub(*a, **kw):
        raise _PastTheDevice

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.delenv("INFERNOS_DEVICE", raising=False)
    monkeypatch.setenv("INFERNOS_MODEL_MODE", "")  # --tiny-real sets it
    monkeypatch.setattr(aiabench, "build_cluster", stub)
    with pytest.raises(SystemExit) as e:
        aiabench.main(["--calls", "1"])
    assert e.value.code == 2
    with pytest.raises(_PastTheDevice):
        aiabench.main(["--tiny-real"])
