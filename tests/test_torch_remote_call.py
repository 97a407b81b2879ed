"""The bilingual LiveTranslator call with its STT served from another process.

The call of ``tests/test_torch_lt_bilingual.py`` (``chip_smoke.py``'s
``drive_sip_call``: SIP, RTP, the LiveTranslator app and both tiny-real TTS
actors in this process, fp32 on the CPU, on the reference's TTS draws),
with ``build_cluster``'s ``stt_actr`` a ``RemoteActorHandle`` to a
tiny-real ``STTActor`` in a peer process (``chip_smoke.Peer``, the port's
``ActorServer``): every VAD segment, STT request and ``text_cb`` crosses a
TCP socket.  What each far end hears, transcribed by the tiny-real STT
here, must reach the in-process call's bar, word accuracy >= 0.6 each
way; the STT numbers are the peer's, read through its probe; the peer's
STT ran every encode of the call and loaded no ``jax`` or reference module.
Ports: SIP 25079 and 25089, RTP 40200-40600 (``chip_smoke.REMOTE_CALL_PORTS``;
no other test file uses them).
"""

import pytest
import torch

import chip_smoke as cs
from infernos_tpu_torch.models import tiny_real
from infernos_tpu_torch.serving import stt_engine as stt
from torch_reference_draws import reference_draws  # noqa: F401  (fixture)


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.e2e
def test_lt_call_with_its_stt_in_a_peer(reference_draws):
    peer = cs.Peer({"INFERNOS_MODEL_MODE": "tiny-real", "OMP_NUM_THREADS": "2"},
                   heartbeat_s=0)
    try:
        far = peer.conn.spawn_remote("infernos_tpu_torch.cluster.model_actors:STTActor",
                                     True, name="stt:peer", device="cpu", timeout=60.0)
        far.ask_sync("start", timeout=600.0)
        call = cs.drive_sip_call(device="cpu", stt_actr=far, ports=cs.REMOTE_CALL_PORTS)
        assert peer.probe.ask_sync("modules") == []
        assert peer.probe.ask_sync("encodes", "stt:peer") >= call["stt_encodes"] >= 2
    finally:
        peer.close()
    assert call["stt"] is None
    assert call["bob_got_bye"], "Bob did not get the BYE"
    assert call["actor_threads_left"] == []
    sp, scfg, stok, secfg = tiny_real.load_tiny_stt("cpu")
    here = stt.STTEngine(sp, scfg, secfg, detokenize=stok.detokenize, device="cpu")
    heard = cs.heard_directions(here, call)
    assert [h["direction"] for h in heard] == ["alice->bob", "bob->alice"]
    for h in heard:
        assert h["stt_results"] >= 1 and h["stt_text"] and all(h["stt_text"])
        assert h["stt_latency_s"] > 0 and h["reply_start_s"] is not None
        assert h["word_acc"] >= cs.ACC_MIN, (
            f"{h['direction']}: expected {h['expected']!r}, heard {h['heard']!r}")
