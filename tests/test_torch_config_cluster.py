"""Config validation + actor runtime tests.

The port's copy of ``tests/test_config_cluster.py``, run against ``infernos_tpu_torch``.
"""

import textwrap
import time

import pytest

from infernos_tpu_torch.cluster.actors import Actor, spawn, stop_all
from infernos_tpu_torch.config import ConfigParseError, InfernConfig
from infernos_tpu_torch.config.validator import validate


GOOD_YAML = textwrap.dedent("""
    sip:
      settings:
        bind: 127.0.0.1:5060
      profiles:
        foo:
          sip_server: 127.0.0.1:6666
          sink: apps/live_translator/configuration1
          username: 'incoming'
          password: 'user'
          register: True
        bar:
          sip_server: 10.0.0.1:5060
          username: '1929132'
          password: 'secret'
    rtp:
      settings:
        min_port: 20000
        max_port: 21000
    apps:
      live_translator:
        profiles:
          configuration1:
            stt_langs: ['en', 'pt']
            tts_langs: ['pt', 'en']
            outbound: sip/bar;cld=1929133
      ai_attendant:
        profiles:
          attendant1:
            stt_lang: en
            tts_lang: en
            llm_prompt: "You are a helpful attendant."
""")


def _write(tmp_path, text):
    p = tmp_path / "config.yaml"
    p.write_text(text)
    return str(p)


def test_config_parses(tmp_path):
    cfg = InfernConfig(_write(tmp_path, GOOD_YAML))
    assert cfg.sip_conf.bind == ("127.0.0.1", 5060)
    assert cfg.rtp_conf.min_port == 20000
    assert set(cfg.connectors) == {"sip/foo", "sip/bar"}
    assert cfg.connectors["sip/foo"].register is True
    assert cfg.connectors["sip/foo"].sink == "apps/live_translator/configuration1"
    lt = cfg.apps["apps/live_translator/configuration1"]
    assert lt.stt_langs == ["en", "pt"]
    assert lt.outbound_parts() == ("sip/bar", "1929133")
    aia = cfg.apps["apps/ai_attendant/attendant1"]
    assert aia.llm_prompt.startswith("You are")


def test_config_bad_sink(tmp_path):
    bad = GOOD_YAML.replace("apps/live_translator/configuration1",
                            "apps/live_translator/nope")
    with pytest.raises(ConfigParseError, match="sink"):
        InfernConfig(_write(tmp_path, bad))


def test_config_bad_port(tmp_path):
    bad = GOOD_YAML.replace("127.0.0.1:5060", "127.0.0.1:99999", 1)
    with pytest.raises(ConfigParseError, match="[Pp]ort"):
        InfernConfig(_write(tmp_path, bad))


def test_config_unknown_field(tmp_path):
    bad = GOOD_YAML.replace("min_port: 20000", "min_port: 20000\n    bogus: 1")
    with pytest.raises(ConfigParseError, match="unknown field"):
        InfernConfig(_write(tmp_path, bad))


def test_validator_types():
    schema = {"n": {"type": "integer"}, "s": {"type": "string", "required": True}}
    validate(schema, {"n": 3, "s": "x"})
    with pytest.raises(ConfigParseError):
        validate(schema, {"n": "three", "s": "x"})
    with pytest.raises(ConfigParseError, match="required"):
        validate(schema, {"n": 3})


class Counter(Actor):
    def __init__(self):
        self.n = 0
        self.started = False

    def on_start(self):
        self.started = True

    def inc(self, by=1):
        self.n += by
        return self.n

    def get(self):
        return self.n

    def boom(self):
        raise ValueError("boom")


def test_actor_serialized_state():
    h = spawn(Counter, name="counter-test")
    try:
        for _ in range(100):
            h.call("inc")
        assert h.ask_sync("get") == 100
        assert h.ask_sync("inc", 5) == 105
        # exceptions propagate through ask
        with pytest.raises(ValueError, match="boom"):
            h.ask_sync("boom")
        # actor still alive afterwards
        assert h.ask_sync("get") == 105
    finally:
        h.stop()


def test_actor_on_start_and_stop():
    h = spawn(Counter, name="counter-test-2")
    assert h.ask_sync("get") == 0
    assert h._actor.started
    h.stop()
    # calls after stop don't crash the caller (queued but never run)
    h.call("inc")


def test_actor_mailbox_survives_dispatch_bug():
    """Copied from ``tests/test_supervision.py``."""

    class Weird(Actor):
        def __init__(self):
            self.calls = 0

        def poke(self):
            self.calls += 1
            return self.calls

    h = spawn(Weird, name="weird-test")
    assert h.ask_sync("poke", timeout=5.0) == 1
    # a fire-and-forget call to a MISSING method must not kill the mailbox
    h.call("no_such_method")
    assert h.ask_sync("poke", timeout=5.0) == 2
    h.stop()
