"""``correct``: the numbers the reference worked out, each against its
limit from the cell's file.  ``structure`` counts the messages of the
structural checks (limit 0); every other number is compared with ``<=``.
A number that is missing or not finite fails."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple


def decide(nums: Dict, limits: Dict[str, float]) -> Tuple[bool, Dict[str, Dict]]:
    """``(correct, {name: {"value", "limit"}})`` over the limited numbers,
    in the order of ``limits``."""
    checks: Dict[str, Dict] = {}
    ok = True
    for name, limit in limits.items():
        value = nums.get(name)
        if name == "structure":
            value = len(value) if value is not None else math.inf
        value = math.inf if value is None else float(value)
        checks[name] = {"value": value, "limit": float(limit)}
        ok = ok and math.isfinite(value) and value <= float(limit)
    return ok, checks


def lines(checks: Dict[str, Dict], messages: List[str]) -> List[str]:
    """The compared numbers as short lines for standard error."""
    out = [f"structure: {m}" for m in messages[:20]]
    out += [f"{name} {c['value']!r} limit {c['limit']!r}" for name, c in checks.items()]
    return out
