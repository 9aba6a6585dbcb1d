"""Go-style duration parsing — ONE grammar for every knob (the port's
copy of ``pilosa_tpu.utils.durations``).

The reference's TOML uses Go durations ('1m30s', '500ms'); bare numbers
are seconds. Every duration knob of ServerConfig (server/server.py)
parses through it, so a unit accepted by one knob is accepted by all.
"""

from __future__ import annotations

import re

_NUMBER = r"[0-9]+(?:\.[0-9]+)?|\.[0-9]+"
_COMPOUND_RE = re.compile(rf"^(?:(?:{_NUMBER})(?:ms|us|s|m|h))+$")
_PARTS_RE = re.compile(rf"({_NUMBER})(ms|us|s|m|h)")
_UNITS = {"us": 1e-6, "ms": 1e-3, "s": 1.0, "m": 60.0, "h": 3600.0}


def parse_duration(value) -> float:
    """Seconds from a float or a Go-style duration string. Empty string
    is 0; malformed input raises ValueError rather than silently
    dropping trailing text."""
    if isinstance(value, (int, float)):
        return float(value)
    s = str(value).strip().lower()
    if not s:
        return 0.0
    if _COMPOUND_RE.fullmatch(s):
        return sum(float(num) * _UNITS[unit]
                   for num, unit in _PARTS_RE.findall(s))
    try:
        return float(s)
    except ValueError:
        raise ValueError(f"invalid duration: {value!r}") from None
