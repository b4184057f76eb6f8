"""Pure HLO-text analysis helpers: per-collective byte counts of a compiled
module's text.

A copy of ``src/repro/launch/hlo_analysis.py`` (which imports no jax
either), kept so that the port imports nothing of the JAX package.  The
port's dry run (:mod:`repro_torch.launch.dryrun`) compiles no HLO, so it
does not call these parsers; they read the reference's compiled modules,
as ``tests/test_torch_tensor_parallel.py`` does to put GSPMD's collectives
beside the port's tensor-parallel plan.
"""

from __future__ import annotations

import re
from typing import Dict

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1,
}

_COLLECTIVES = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute",
)

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_RESULT_RE = re.compile(
    r"=\s+(.*?)\s+(" + "|".join(_COLLECTIVES) + r")(?:-start)?\("
)


def _shape_bytes(text: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(text):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def collective_bytes(hlo_text: str) -> Dict[str, int]:
    """Sum result-shape bytes of every collective op in the HLO, by kind."""
    out: Dict[str, int] = {c: 0 for c in _COLLECTIVES}
    for line in hlo_text.splitlines():
        m = _RESULT_RE.search(line)
        if not m:
            continue
        if "-done(" in line:
            continue  # async pairs: count the -start only
        result_type, kind = m.group(1), m.group(2)
        out[kind] += _shape_bytes(result_type)
    out["total"] = sum(out[c] for c in _COLLECTIVES)
    return out
