"""The run's verdict: `correct` is the conjunction of the checks the result
line prints, each its reading against its limit by one comparison, <=.

A reading that is not a finite number fails. A check without a limit is
malformed and raises: nothing is printed that the verdict does not use.
"""

from __future__ import annotations

import math
import sys
from typing import Dict, Mapping


def passes(value, limit) -> bool:
    """value <= limit, for finite numbers only."""
    if not isinstance(value, (int, float)) or isinstance(value, bool):
        return False
    if not isinstance(limit, (int, float)) or isinstance(limit, bool):
        raise ValueError(f"limit {limit!r} is not a number")
    return math.isfinite(value) and value <= limit


def verdict(checks: Mapping[str, Mapping[str, float]]) -> bool:
    """True when every check's value is <= its limit (and there is at
    least one check). Raises ValueError on a check without a limit."""
    if not checks:
        return False
    ok = True
    for name, c in checks.items():
        if "limit" not in c or "value" not in c:
            raise ValueError(f"check {name!r} lacks a value or a limit")
        ok = passes(c["value"], c["limit"]) and ok
    return ok


def make_checks(readings: Mapping[str, float],
                limits: Mapping[str, float]) -> Dict[str, Dict[str, float]]:
    """{name: {"value", "limit"}} for every reading; a reading without a
    limit in `limits` raises (a check must be judged)."""
    out = {}
    for name in sorted(readings):
        if name not in limits:
            raise KeyError(f"no limit for check {name!r}")
        out[name] = {"value": float(readings[name]),
                     "limit": float(limits[name])}
    return out


def print_checks(checks: Mapping[str, Mapping[str, float]],
                 stream=None) -> bool:
    """Each check on its own line, then the verdict, on `stream` (standard
    error by default). Returns the verdict."""
    stream = stream or sys.stderr
    for name, c in checks.items():
        mark = "ok" if passes(c["value"], c["limit"]) else "FAIL"
        print(f"check {name} {c['value']!r} <= {c['limit']!r} {mark}",
              file=stream)
    ok = verdict(checks)
    print(f"correct {str(ok).lower()}", file=stream, flush=True)
    return ok
