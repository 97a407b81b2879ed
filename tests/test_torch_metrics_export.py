"""Operator metrics surface: /metrics endpoint + SIGUSR1 dump.

VERDICT r2 item 9: the registry (engine latencies, RTCP peer stats) must be
visible on a running daemon.  Match: reference tensorboardX export
(``Apps/LiveTranslator/LTActor.py:82-85``) + Ray dashboard.

The port's copy of ``tests/test_metrics_export.py``, run against ``infernos_tpu_torch``.
"""

import json
import urllib.request

from infernos_tpu_torch.utils.metrics import Metrics
from infernos_tpu_torch.utils.metrics_export import (MetricsServer,
                                               render_prometheus)


def test_prometheus_rendering_sanitizes_names():
    text = render_prometheus({"stt.inf_time.p95": 1.5, "a-b c": 2.0})
    assert "infernos_stt_inf_time_p95 1.5" in text
    assert "infernos_a_b_c 2" in text


def test_metrics_endpoint_serves_registry_and_collectors():
    reg = Metrics()
    reg.observe("stt.inf_time", 0.5)
    reg.inc("calls")
    srv = MetricsServer(port=0, host="127.0.0.1", registry=reg).start()
    try:
        srv.add_collector(lambda: {"rtcp.peer_jitter_ms": 3.25})
        base = f"http://127.0.0.1:{srv.port}"
        text = urllib.request.urlopen(f"{base}/metrics").read().decode()
        assert "infernos_stt_inf_time_p50" in text
        assert "infernos_calls 1" in text
        assert "infernos_rtcp_peer_jitter_ms 3.25" in text
        js = json.loads(
            urllib.request.urlopen(f"{base}/metrics.json").read())
        assert js["calls"] == 1
        assert js["rtcp.peer_jitter_ms"] == 3.25
        # unknown path -> 404
        try:
            urllib.request.urlopen(f"{base}/nope")
            assert False, "expected 404"
        except urllib.error.HTTPError as e:
            assert e.code == 404
    finally:
        srv.close()


def test_broken_collector_does_not_break_scrape():
    reg = Metrics()
    reg.inc("ok")
    srv = MetricsServer(port=0, host="127.0.0.1", registry=reg).start()
    try:
        srv.add_collector(lambda: 1 / 0)
        text = urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/metrics").read().decode()
        assert "infernos_ok 1" in text
    finally:
        srv.close()


def test_config_metrics_section(tmp_path):
    from infernos_tpu_torch.config import InfernConfig

    cfg = tmp_path / "c.yaml"
    cfg.write_text(
        "sip:\n  settings:\n    bind: '127.0.0.1:15060'\n"
        "metrics:\n  port: 19464\n  bind: '127.0.0.1'\n")
    ic = InfernConfig(str(cfg))
    assert ic.metrics_port == 19464
    assert ic.metrics_bind == "127.0.0.1"
