"""The LiveTranslator call benches of ``tests/test_call_benches.py`` on the
port (``infernos_tpu_torch.bench.ltbench``): real SIP and RTP over loopback
into ``build_cluster(tiny=True, device="cpu")`` with tiny random models.

Beside the reference's case, one ramp level at two calls, held to its
fleet bookkeeping (every turn is measured or counted failed, the level's
far-end sockets are closed after it), and the ramp's stop rule on a stub
level.  No assertion hangs on how fast a loaded CPU serves a turn beyond
the reference's own bound.
Ports: SIP 25096 (the cluster) and 25097 (the far end), RTP 39000-39400;
no other test file uses them.
"""

import textwrap

import pytest
import torch

from infernos_tpu_torch.bench import ltbench
from infernos_tpu_torch.bench.ltbench import (
    LTLevelResult, MultiFarEnd, run_lt_bench, run_lt_level, run_lt_ramp,
)
from infernos_tpu_torch.cluster.actors import stop_all
from infernos_tpu_torch.config import InfernConfig
from infernos_tpu_torch.main import build_cluster

SIP_PORT, FAR_PORT = 25096, 25097


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Few intra-op threads: the tiny models' ops are small, and a loaded
    CPU stalls a wide thread pool on its slowest thread every op."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lt_fleet(tmp_path_factory):
    """(SIP address of the cluster, the far end every call is bridged to)."""
    p = tmp_path_factory.mktemp("ltbench") / "lt.yaml"
    p.write_text(textwrap.dedent(f"""
        sip:
          settings:
            bind: 127.0.0.1:{SIP_PORT}
          profiles:
            inbound:
              sink: apps/live_translator/bench
            bob:
              sip_server: 127.0.0.1:{FAR_PORT}
        rtp:
          settings:
            min_port: 39000
            max_port: 39400
        apps:
          live_translator:
            profiles:
              bench:
                stt_langs: ['en', 'pt']
                tts_langs: ['pt', 'en']
                outbound: sip/bob;cld=900
    """))
    iconf = InfernConfig(str(p))
    far = MultiFarEnd(port=FAR_PORT)
    try:
        build_cluster(iconf, tiny=True, bind_ip="127.0.0.1", device="cpu")
        yield iconf.sip_conf.bind, far
    finally:
        stop_all()
        far.close()


@pytest.mark.e2e
def test_lt_multi_call_bench(lt_fleet):
    bind, far = lt_fleet
    r = run_lt_bench(bind, far, n_calls=2, turns=1, turn_timeout=60.0)
    assert r.answered == 2, r
    assert r.turns >= 1, r  # at least one measured translate turn
    assert r.turn_p50_s < 30.0, r


@pytest.mark.e2e
def test_lt_level_bookkeeping(lt_fleet):
    """One ramp level of two calls, one turn each: both answered, every
    turn measured or counted failed, and the level's B-leg sockets closed
    when it ends."""
    bind, far = lt_fleet
    first = far.n_calls()
    r = run_lt_level(bind, far, 2, turns=1, turn_timeout=60.0)
    assert r.n_calls == 2 and r.answered == 2, r
    assert r.turns_measured + r.failures == 2 * 1, r
    assert r.wall_s > 0 and r.turn_p50_s <= r.turn_p95_s, r
    assert r.ok == (r.failures == 0 and r.turns_measured > 0
                    and r.turn_p95_s <= 3.5), r
    level_calls = far.calls[first:]
    assert len(level_calls) == 2
    assert all("sock" not in c for c in level_calls)


def _stub_levels(monkeypatch, ok_at):
    """``run_lt_level`` stubbed: a level passes when ``ok_at(n, seed)``."""
    calls = []

    def level(sip_bind, far_end, n, turns=2, utter_s=1.6, sla_turn_s=3.5,
              seed=42):
        calls.append((n, seed))
        ok = ok_at(n, seed)
        return LTLevelResult(n_calls=n, answered=n, turns_measured=n * turns,
                             turn_p50_s=1.0, turn_p95_s=1.0 if ok else 9.0,
                             failures=0, wall_s=1.0, ok=ok)

    monkeypatch.setattr(ltbench, "run_lt_level", level)
    return calls


def test_lt_ramp_stops_after_a_failing_level_and_its_retry(monkeypatch):
    calls = _stub_levels(monkeypatch, lambda n, seed: n <= 2)
    published = []
    best, results = run_lt_ramp(None, None, [1, 2, 4, 8],
                                on_level=lambda b, rs: published.append(
                                    (b and b.n_calls, len(rs))))
    assert calls == [(1, 42), (2, 42), (4, 42), (4, 42 + 17)]  # 8 never runs
    assert best.n_calls == 2 and [r.n_calls for r in results] == [1, 2, 4, 4]
    # a line after each level, and one before the failed level's retry
    assert published == [(1, 1), (2, 2), (2, 3), (2, 4)]


def test_lt_ramp_goes_on_when_the_retry_passes(monkeypatch):
    calls = _stub_levels(monkeypatch, lambda n, seed: n != 2 or seed != 42)
    best, results = run_lt_ramp(None, None, [1, 2, 4])
    assert calls == [(1, 42), (2, 42), (2, 59), (4, 42)]
    assert best.n_calls == 4 and [r.ok for r in results] == [True, False, True, True]
