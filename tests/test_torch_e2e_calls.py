"""The LiveTranslator bridge of ``tests/test_e2e_calls.py`` on the port.

Real SIP signaling and real RTP media over loopback through the port's
actor graph (``infernos_tpu_torch.main.build_cluster``) with tiny random
weights on the CPU (``device="cpu"``): a simulated phone (Alice) calls
in, the app dials Bob through the ``sip/bob`` connector, Alice's speech
surfaces as TTS audio on Bob's leg and the VAD engage jingle on hers.
Ports: SIP 25071 and 25080, RTP 34000-34400 (no other test file uses them).
"""

import textwrap
import time

import numpy as np
import pytest

from infernos_tpu_torch.bench.phone import FakePhone, FarEnd
from infernos_tpu_torch.cluster.actors import stop_all
from infernos_tpu_torch.config import InfernConfig
from infernos_tpu_torch.main import build_cluster

SIP_PORT, BOB_PORT = 25071, 25080
SILENT = 1e-3  # a sample at or under this magnitude is silence


def _speechy(seconds, sr=8000, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    return (0.35 * np.sin(2 * np.pi * 280 * t)
            * (1 + 0.2 * rng.standard_normal(len(t)))).astype(np.float32)


def _band_power(x, f, sr=8000):
    t = np.arange(len(x)) / sr
    return (abs(x @ np.exp(-2j * np.pi * f * t)) / len(x)) ** 2


@pytest.fixture(scope="module")
def lt_cluster(tmp_path_factory):
    p = tmp_path_factory.mktemp("lt") / "lt.yaml"
    p.write_text(textwrap.dedent(f"""
        sip:
          settings:
            bind: 127.0.0.1:{SIP_PORT}
          profiles:
            inbound:
              sink: apps/live_translator/c1
            bob:
              sip_server: 127.0.0.1:{BOB_PORT}
        rtp:
          settings:
            min_port: 34000
            max_port: 34400
        apps:
          live_translator:
            profiles:
              c1:
                stt_langs: ['en', 'pt']
                tts_langs: ['pt', 'en']
                outbound: sip/bob;cld=900
    """))
    iconf = InfernConfig(str(p))
    try:
        yield iconf, build_cluster(iconf, tiny=True, bind_ip="127.0.0.1",
                                   device="cpu")
    finally:
        stop_all()


@pytest.mark.e2e
def test_live_translator_bridge(lt_cluster):
    """Alice calls in; the app dials Bob; Alice's speech surfaces as TTS
    audio on Bob's leg (peak > 1e-3, as the original test holds it) and
    the engage jingle (440/660 Hz, over 10x the power of two off-jingle
    bands) on Alice's."""
    iconf, handles = lt_cluster
    assert {"rtp", "sip", "apps/live_translator/c1"} <= set(handles)
    bob = FarEnd(port=BOB_PORT)
    alice = FakePhone()
    try:
        alice.call(iconf.sip_conf.bind)
        assert alice.uac.connected
        assert bob.answered.wait(20.0), "outbound leg never reached Bob"

        alice.stream_bg(_speechy(1.2, seed=7), then_silence=True)
        deadline = time.monotonic() + 90
        while time.monotonic() < deadline:
            audio = bob.rx_audio()
            if len(audio) > 800 and np.abs(audio).max() > SILENT:
                break
            time.sleep(0.25)
        alice.stop_streaming()
        audio = bob.rx_audio()
        assert len(audio) > 800, "no translated TTS audio reached Bob"
        assert np.abs(audio).max() > SILENT

        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            a_audio = alice.rx_audio()
            if len(a_audio) >= 1200 and np.abs(a_audio).max() > SILENT:
                break
            time.sleep(0.25)
        a_audio = alice.rx_audio()
        assert len(a_audio) >= 1200, "no VAD signal audio on Alice's leg"
        p_tone = _band_power(a_audio, 440.0) + _band_power(a_audio, 660.0)
        p_ref = _band_power(a_audio, 1150.0) + _band_power(a_audio, 1730.0)
        assert p_tone > 10 * max(p_ref, 1e-12), (p_tone, p_ref)
        alice.hangup()
    finally:
        alice.close()
        bob.close()


def test_tiny_random_actors_on_cpu_use_the_plain_path(lt_cluster):
    """The cluster's model actors serve on the CPU device they were given,
    in fp32, one dense TTS engine per language and one STT engine."""
    import torch

    from infernos_tpu_torch.cluster.actors import lookup

    for lang in ("pt", "en"):
        tts = lookup(f"tts:c1:{lang}")
        assert tts is not None
        eng = tts._actor.engine
        assert eng.device == torch.device("cpu") and eng.ecfg.dtype == torch.float32
    stt = lookup("stt:c1")
    eng = stt._actor.engine
    assert eng.device == torch.device("cpu") and eng.ecfg.dtype == torch.float32
