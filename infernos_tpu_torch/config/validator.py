"""Minimal schema validator (cerberus-subset) + YAML loading.

Capability parity with ``Core/ConfigValidators.py:6-17``: the reference
validates its YAML against a cerberus schema assembled from per-module
fragments.  cerberus is not a baked-in dependency here, so this implements
the subset of its schema language the config surface uses: ``type``,
``schema`` (dict and list element schemas), ``required``, ``allowed``,
``regex``, ``keysrules``/``valuesrules``, ``check_with`` callables.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, List

import yaml


class ConfigParseError(Exception):
    pass


_TYPES = {
    "dict": dict,
    "list": list,
    "string": str,
    "integer": int,
    "float": (int, float),
    "boolean": bool,
}


def _validate_node(schema: Dict[str, Any], value: Any, path: str,
                   errors: List[str]) -> None:
    t = schema.get("type")
    if t is not None:
        pytype = _TYPES.get(t)
        if pytype is None:
            errors.append(f"{path}: unknown schema type {t!r}")
            return
        if t == "boolean" and isinstance(value, int) and not isinstance(value, bool):
            errors.append(f"{path}: expected boolean")
            return
        if not isinstance(value, pytype) or (
                t == "integer" and isinstance(value, bool)):
            errors.append(f"{path}: expected {t}, got {type(value).__name__}")
            return
    if "allowed" in schema and value not in schema["allowed"]:
        errors.append(f"{path}: {value!r} not in allowed {schema['allowed']}")
    if "regex" in schema and isinstance(value, str):
        if not re.fullmatch(schema["regex"], value):
            errors.append(f"{path}: {value!r} does not match {schema['regex']}")
    if "check_with" in schema:
        def err(field, msg):
            errors.append(f"{path}: {msg}")
        schema["check_with"](path, value, err)
    if t == "dict":
        sub = schema.get("schema")
        if sub is not None:
            for key, ks in sub.items():
                if key in value:
                    _validate_node(ks, value[key], f"{path}.{key}", errors)
                elif ks.get("required"):
                    errors.append(f"{path}.{key}: required field missing")
            if not schema.get("allow_unknown", False):
                for key in value:
                    if key not in sub:
                        errors.append(f"{path}.{key}: unknown field")
        vr = schema.get("valuesrules")
        if vr is not None:
            for key, v in value.items():
                _validate_node(vr, v, f"{path}.{key}", errors)
    elif t == "list":
        es = schema.get("schema")
        if es is not None:
            for i, v in enumerate(value):
                _validate_node(es, v, f"{path}[{i}]", errors)


def validate(schema: Dict[str, Any], data: Any, root: str = "config") -> None:
    errors: List[str] = []
    _validate_node({"type": "dict", "schema": schema}, data, root, errors)
    if errors:
        raise ConfigParseError("; ".join(errors))


def validate_yaml(schema: Dict[str, Any], filename: str) -> Dict[str, Any]:
    try:
        with open(filename) as f:
            data = yaml.safe_load(f)
    except yaml.YAMLError as exc:
        raise ConfigParseError(f"YAML error in {filename}: {exc}") from exc
    validate(schema, data, root=filename)
    return data


def validate_port_range(field: str, value: str, error: Callable) -> None:
    """'host[:port]' port-range check (reference ``ConfigValidators.py:19-23``)."""
    if ":" in value:
        _, port = value.rsplit(":", 1)
        if not port.isdigit() or not (1 <= int(port) <= 65535):
            error(field, "Port number must be in the range 1-65535")
