"""Intelligent log parser (ACAI §3.2.3): user programs print specially
formatted lines and the platform auto-attaches them as metadata.

A copy of ``repro/core/engine/logparse.py``, with its imports
in ``repro_torch.core``.

Recognized formats (tolerant):
    [[acai:key=value]]
    [[acai:key=value,key2=value2]]
Values are parsed as float/int when possible.
"""
from __future__ import annotations

import re
from typing import Any

_PATTERN = re.compile(r"\[\[acai:([^\]]+)\]\]")


def _coerce(v: str) -> Any:
    v = v.strip()
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    return v


def parse_line(line: str) -> dict[str, Any]:
    out: dict[str, Any] = {}
    for m in _PATTERN.finditer(line):
        for pair in m.group(1).split(","):
            if "=" in pair:
                k, v = pair.split("=", 1)
                out[k.strip()] = _coerce(v)
    return out


def parse_log(text: str) -> dict[str, Any]:
    out: dict[str, Any] = {}
    for line in text.splitlines():
        out.update(parse_line(line))
    return out
