"""The AI attendant on the port, through real SIP and RTP calls into its
daemon graph (``infernos_tpu_torch.main.build_cluster``), on the CPU.

- The attendant call of ``tests/test_e2e_calls.py`` on tiny random weights
  (``device="cpu"``): a phone calls in, speaks, and hears synthesized audio
  back (STT -> LLM -> TTS as RTP, peak above 1e-3 as the original holds it).
- The tiny-real attendant call, fp32: ``chip_smoke.py``'s
  ``drive_aia_call`` (the ``aia_call`` phase on the card), on the
  reference's TTS draws (``tests/torch_reference_draws.py``).  Alice says
  "hello" (merged into the call's metadata turn, answered with the
  greeting) and then "billing please"; each LLM reply must be the
  policy's (``tools/train_tiny_llm.py``), each say must end, her packets
  must carry the audio the TTS emitted (``chip_smoke.reply_checks``) and
  what she heard must reach word accuracy 0.6 against what the TTS said
  (``chip_smoke.heard_checks``).  After she hangs up, the session ends and
  no actor thread is left.
- The tiny STT on the call's speech from the clean renderer, in both
  packages: the port's transcripts equal the JAX package's for Alice's
  second line over render seeds 20-35 (each hears "billing") and for the
  policy's two six-word replies over seeds 20-23, which the tiny STT,
  trained on one to four words, hears badly (the accuracies are printed).
Ports: SIP 25076 and 25078, RTP 37000-37400 and 37500-37900 (no other test
file uses them).
"""

import textwrap
import time

import numpy as np
import pytest
import torch

import chip_smoke as cs
from infernos_tpu_torch.bench.phone import FakePhone
from infernos_tpu_torch.cluster.actors import stop_all
from infernos_tpu_torch.config import InfernConfig
from infernos_tpu_torch.main import build_cluster
from torch_reference_draws import reference_draws  # noqa: F401  (fixture)

SIP_PORT = 25078
SILENT = 1e-3


def _speechy(seconds, sr=8000, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    return (0.35 * np.sin(2 * np.pi * 280 * t)
            * (1 + 0.2 * rng.standard_normal(len(t)))).astype(np.float32)


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def aia_cluster(tmp_path, monkeypatch):
    monkeypatch.delenv("INFERNOS_MODEL_MODE", raising=False)
    p = tmp_path / "aia.yaml"
    p.write_text(textwrap.dedent(f"""
        sip:
          settings:
            bind: 127.0.0.1:{SIP_PORT}
          profiles:
            inbound:
              sink: apps/ai_attendant/a1
        rtp:
          settings:
            min_port: 37500
            max_port: 37900
        apps:
          ai_attendant:
            profiles:
              a1:
                stt_lang: en
                tts_lang: en
                llm_prompt: "You are a phone attendant. Be brief."
    """))
    iconf = InfernConfig(str(p))
    try:
        yield iconf, build_cluster(iconf, tiny=True, bind_ip="127.0.0.1", device="cpu")
    finally:
        stop_all()


@pytest.mark.e2e
def test_ai_attendant_full_call(aia_cluster):
    """Phone calls in; speaks; hears synthesized audio back; hangs up."""
    iconf, handles = aia_cluster
    assert {"rtp", "sip", "apps/ai_attendant/a1"} <= set(handles)
    phone = FakePhone()
    try:
        params = phone.call(iconf.sip_conf.bind)
        assert phone.uac.connected
        assert params.rtp_target[1] >= 37500  # the framework's media port
        # speak ~1.2 s, then keep the line open with silence so the 2 s
        # flush fires; wait for STT -> LLM -> TTS to come back as RTP
        phone.stream_bg(_speechy(1.2), then_silence=True)
        deadline = time.monotonic() + 90
        while time.monotonic() < deadline:
            audio = phone.rx_audio()
            if len(audio) > 800 and np.abs(audio).max() > SILENT:
                break
            time.sleep(0.25)
        phone.stop_streaming()
        audio = phone.rx_audio()
        assert len(audio) > 800, "no reply audio from the attendant"
        assert np.abs(audio).max() > SILENT, "reply audio is silent"
        phone.hangup()
    finally:
        phone.close()


@pytest.mark.e2e
def test_tiny_real_attendant_call(reference_draws):
    call = cs.drive_aia_call(device="cpu")
    assert call["actor_threads_left"] == [] and call["sessions_left"] == 0
    assert call["stt"].device == torch.device("cpu")
    assert call["llm"].ecfg.dtype == torch.float32
    assert [t.text for t in call["turns"]] == [line[0] for line in cs.AIA_LINES]
    for t in call["turns"]:
        assert t.stt_results >= 1 and t.stt_text and all(t.stt_text), "no transcript"
        assert t.llm_replies >= 1 and t.llm_text, "no LLM reply"
    assert cs.reply_checks(call["turns"]) == []
    rows, unheard = cs.heard_checks(call["stt"], call["turns"])
    print(rows)
    assert unheard == []


def test_tiny_stt_hears_the_call_alike_in_both_packages():
    from infernos_tpu.audio.chunk import AudioChunk as JChunk
    from infernos_tpu.models import tiny_real as jtr
    from infernos_tpu.serving import stt_engine as jstt
    from infernos_tpu_torch.models import tiny_real
    from infernos_tpu_torch.serving.stt_engine import STTEngine

    sp, scfg, stok, secfg = tiny_real.load_tiny_stt("cpu")
    port = STTEngine(sp, scfg, secfg, detokenize=stok.detokenize, device="cpu")
    jp, jcfg, jtok, jecfg = jtr.load_tiny_stt()
    ref = jstt.STTEngine(jp, jcfg, jecfg, detokenize=jtok.detokenize)

    def ref_transcribe(audio8k):
        out = []
        ref.submit(jstt.STTRequest(audio=JChunk(audio8k, 8000).resample(16000).audio,
                                   text_cb=out.append, lang="en"))
        while ref.step():
            pass
        return out[0].text

    line = cs.AIA_LINES[1][0]
    replies = [expect for _, _, expect in cs.AIA_LINES]
    cases = [(line, s) for s in range(20, 36)] + [(r, s) for r in replies for s in range(20, 24)]
    got, want = [], []
    for text, seed in cases:
        audio = cs.render_speech(text, seed)
        got.append(cs.transcribe(port, audio, "en"))
        want.append(ref_transcribe(audio))
    print([(t, s, h, cs.word_acc(t, h)) for (t, s), h in zip(cases, got)])
    assert got == want
    assert all("billing" in h.split() for (t, _), h in zip(cases, got) if t == line)
