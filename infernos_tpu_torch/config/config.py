"""Framework configuration: YAML surface compatible with the reference.

Capability parity with ``Core/InfernConfig.py:40-70``: the same hierarchical
layout --

.. code-block:: yaml

    sip:
      settings: {bind: "ip[:port]"}
      profiles:
        <name>: {sip_server: "ip[:port]", username: ..., password: ...,
                 register: true, sink: "apps/<app>/<profile>"}
    rtp:
      settings: {min_port: N, max_port: N}
    apps:
      live_translator:
        profiles:
          <name>: {stt_langs: [...], tts_langs: [...], outbound: "sip/<conn>;cld=<num>"}
      ai_attendant:
        profiles:
          <name>: {stt_lang: ..., tts_lang: ..., llm_prompt: <path>}

``connectors`` maps ``sip/<name>`` -> SIPProfileConf and ``apps`` maps
``apps/<app>/<prof>`` -> app profile, exactly the reference's addressing
(``Core/InfernConfig.py:51,60``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from .validator import ConfigParseError, validate_port_range, validate_yaml


def _addr(value: str, default_port: int) -> Tuple[str, int]:
    if ":" in value:
        host, port = value.rsplit(":", 1)
        return host, int(port)
    return value, default_port


@dataclasses.dataclass
class SIPConf:
    """Global SIP settings (reference ``SIP/InfernSIPConf.py``)."""

    bind: Tuple[str, int] = ("0.0.0.0", 5060)

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "SIPConf":
        if not d or "bind" not in d:
            return cls()
        return cls(bind=_addr(d["bind"], 5060))


@dataclasses.dataclass
class RTPConf:
    """RTP port range (reference ``RTP/InfernRTPConf.py``)."""

    min_port: int = 18000
    max_port: int = 22000

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "RTPConf":
        if not d:
            return cls()
        return cls(min_port=d.get("min_port", 18000),
                   max_port=d.get("max_port", 22000))


@dataclasses.dataclass
class SIPProfileConf:
    """Per-peer connector (reference ``SIP/InfernSIPProfile.py``)."""

    name: str
    sip_server: Optional[Tuple[str, int]] = None
    username: Optional[str] = None
    password: Optional[str] = None
    register: bool = False
    sink: Optional[str] = None  # "apps/<app>/<profile>"

    @classmethod
    def from_dict(cls, name: str, d: dict) -> "SIPProfileConf":
        return cls(
            name=name,
            sip_server=_addr(d["sip_server"], 5060) if "sip_server" in d else None,
            username=d.get("username"),
            password=d.get("password"),
            register=bool(d.get("register", False)),
            sink=d.get("sink"),
        )


@dataclasses.dataclass
class LTProfileConf:
    """LiveTranslator app profile (reference ``Apps/LiveTranslator/LTProfile.py``)."""

    name: str
    stt_langs: List[str]
    tts_langs: List[str]
    outbound: Optional[str] = None  # "sip/<conn>;cld=<number>"

    @classmethod
    def from_dict(cls, name: str, d: dict) -> "LTProfileConf":
        return cls(name=name, stt_langs=list(d["stt_langs"]),
                   tts_langs=list(d["tts_langs"]), outbound=d.get("outbound"))

    def outbound_parts(self) -> Tuple[str, str]:
        assert self.outbound, "no outbound configured"
        conn, _, tail = self.outbound.partition(";")
        cld = dict(p.partition("=")[::2] for p in tail.split(";") if p).get("cld", "")
        return conn, cld


@dataclasses.dataclass
class AIAProfileConf:
    """AIAttendant app profile (reference ``Apps/AIAttendant/AIAProfile.py``)."""

    name: str
    stt_lang: str = "en"
    tts_lang: str = "en"
    llm_prompt: str = ""  # contents (reference reads the file at config time)

    @classmethod
    def from_dict(cls, name: str, d: dict) -> "AIAProfileConf":
        prompt = d.get("llm_prompt", "")
        if prompt and "\n" not in prompt:
            try:
                with open(prompt) as f:
                    prompt = f.read()
            except OSError:
                pass  # treat as a literal prompt string
        return cls(name=name, stt_lang=d.get("stt_lang", "en"),
                   tts_lang=d.get("tts_lang", "en"), llm_prompt=prompt)


SCHEMA = {
    "sip": {
        "type": "dict",
        "schema": {
            "settings": {
                "type": "dict",
                "schema": {"bind": {"type": "string",
                                    "check_with": validate_port_range}},
            },
            "profiles": {
                "type": "dict",
                "valuesrules": {
                    "type": "dict",
                    "schema": {
                        "sip_server": {"type": "string",
                                       "check_with": validate_port_range},
                        "username": {"type": "string"},
                        "password": {"type": "string"},
                        "register": {"type": "boolean"},
                        "sink": {"type": "string"},
                    },
                },
            },
        },
    },
    "rtp": {
        "type": "dict",
        "schema": {
            "settings": {
                "type": "dict",
                "schema": {"min_port": {"type": "integer"},
                           "max_port": {"type": "integer"}},
            },
        },
    },
    "metrics": {
        "type": "dict",
        "schema": {
            "port": {"type": "integer"},  # /metrics HTTP endpoint
            "bind": {"type": "string"},
        },
    },
    "apps": {
        "type": "dict",
        "schema": {
            "live_translator": {
                "type": "dict",
                "schema": {
                    "profiles": {
                        "type": "dict",
                        "valuesrules": {
                            "type": "dict",
                            "schema": {
                                "stt_langs": {"type": "list",
                                              "schema": {"type": "string"}},
                                "tts_langs": {"type": "list",
                                              "schema": {"type": "string"}},
                                "outbound": {"type": "string"},
                            },
                        },
                    },
                },
            },
            "live_translator_precache": {"type": "boolean"},
            "ai_attendant": {
                "type": "dict",
                "schema": {
                    "profiles": {
                        "type": "dict",
                        "valuesrules": {
                            "type": "dict",
                            "schema": {
                                "stt_lang": {"type": "string"},
                                "tts_lang": {"type": "string"},
                                "llm_prompt": {"type": "string"},
                            },
                        },
                    },
                },
            },
        },
    },
}


class InfernConfig:
    """Parsed + validated configuration object graph."""

    def __init__(self, filename: str):
        d = validate_yaml(SCHEMA, filename)
        self.sip_conf = SIPConf.from_dict(d.get("sip", {}).get("settings"))
        self.rtp_conf = RTPConf.from_dict(d.get("rtp", {}).get("settings"))
        self.connectors: Dict[str, SIPProfileConf] = {
            f"sip/{name}": SIPProfileConf.from_dict(name, conf)
            for name, conf in d.get("sip", {}).get("profiles", {}).items()
        }
        m = d.get("metrics", {}) or {}
        self.metrics_port: Optional[int] = m.get("port")
        self.metrics_bind: str = m.get("bind", "127.0.0.1")
        self.apps: Dict[str, object] = {}
        apps = d.get("apps", {})
        self.precache = bool(apps.get("live_translator_precache", False))
        for name, conf in apps.get("live_translator", {}).get("profiles", {}).items():
            self.apps[f"apps/live_translator/{name}"] = LTProfileConf.from_dict(name, conf)
        for name, conf in apps.get("ai_attendant", {}).get("profiles", {}).items():
            self.apps[f"apps/ai_attendant/{name}"] = AIAProfileConf.from_dict(name, conf)
        # sanity: every sink must resolve
        for conn in self.connectors.values():
            if conn.sink and conn.sink not in self.apps:
                raise ConfigParseError(
                    f"connector {conn.name!r} sink {conn.sink!r} not defined")
        for app in self.apps.values():
            if isinstance(app, LTProfileConf) and app.outbound:
                conn = app.outbound.partition(";")[0]
                if conn not in self.connectors:
                    raise ConfigParseError(
                        f"LT profile {app.name!r} outbound {conn!r} not defined")
