"""Structured config: defaults, a YAML file and a CLI dotlist merged as
nested dicts. A copy of ``build_config``, ``merge`` and ``apply_dotlist``
from ``multimodal_tpu/utils/config.py``.

The dotlist's values are parsed here as the YAML scalars the JAX package
reads them as (null, booleans, ints, floats, quoted strings, flow lists and
mappings), without PyYAML; a value that is still a string but reads as a
float (``5e-4``) becomes one, as there. PyYAML is imported only to read a
``--config`` file.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Sequence

_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)")
_FLOAT = re.compile(r"[-+]?(\.[0-9]+|[0-9][0-9_]*(\.[0-9_]*)?)([eE][-+][0-9]+)?")
_SPECIAL_FLOAT = {".inf": float("inf"), "+.inf": float("inf"), "-.inf": float("-inf"),
                  ".nan": float("nan")}


def load_yaml(path: str) -> Dict[str, Any]:
    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f)
    return cfg or {}


def merge(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    """Deep-merge ``override`` into ``base`` (override wins), new dict out."""
    out = dict(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merge(out[k], v)
        else:
            out[k] = v
    return out


def _split_top(text: str) -> List[str]:
    """Split a flow collection's inside at the commas outside brackets and
    quotes."""
    parts, depth, quote, start = [], 0, None, 0
    for i, ch in enumerate(text):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "\"'":
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        elif ch == "," and depth == 0:
            parts.append(text[start:i])
            start = i + 1
    parts.append(text[start:])
    return [p for p in parts if p.strip()]


def parse_scalar(raw: str) -> Any:
    """A dotlist value as PyYAML's ``safe_load`` reads it: null, bool, int,
    float, quoted string, ``[...]`` list or ``{k: v}`` mapping; else the
    string itself."""
    s = raw.strip()
    if len(s) >= 2 and s[0] in "\"'" and s[-1] == s[0]:
        return s[1:-1]
    if s[:1] == "[" and s[-1:] == "]":
        return [parse_scalar(p) for p in _split_top(s[1:-1])]
    if s[:1] == "{" and s[-1:] == "}":
        out = {}
        for item in _split_top(s[1:-1]):
            key, _, value = item.partition(":")
            out[parse_scalar(key)] = parse_scalar(value)
        return out
    if s in _NULL:
        return None
    if s in _TRUE:
        return True
    if s in _FALSE:
        return False
    if _INT.fullmatch(s):
        return int(s.replace("_", ""))
    if _FLOAT.fullmatch(s) and "." in s:
        return float(s.replace("_", ""))
    if s.lower() in _SPECIAL_FLOAT:
        return _SPECIAL_FLOAT[s.lower()]
    return s


def apply_dotlist(cfg: Dict[str, Any], dotlist: Sequence[str]) -> Dict[str, Any]:
    """Apply ``a.b.c=value`` overrides (values parsed as YAML scalars)."""
    out = dict(cfg)
    for item in dotlist:
        if "=" not in item:
            raise ValueError(f"dotlist entry must be key=value, got {item!r}")
        key, _, raw = item.partition("=")
        value = parse_scalar(raw)
        if isinstance(value, str):
            # YAML 1.1 misses dot-less exponent floats like "5e-4"
            try:
                value = float(value)
            except ValueError:
                pass
        node = out
        parts = key.strip().split(".")
        for p in parts[:-1]:
            nxt = node.get(p)
            node[p] = dict(nxt) if isinstance(nxt, dict) else {}
            node = node[p]
        node[parts[-1]] = value
    return out


def build_config(
    yaml_path: Optional[str] = None,
    overrides: Sequence[str] = (),
    defaults: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """defaults <- yaml <- CLI dotlist."""
    cfg: Dict[str, Any] = dict(defaults or {})
    if yaml_path:
        cfg = merge(cfg, load_yaml(yaml_path))
    return apply_dotlist(cfg, overrides)
