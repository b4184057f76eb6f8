"""Deterministic fault injection: a seeded plan, fired through fixed hooks.

Counterpart of ``src/repro/resilience/chaos.py`` (numpy and the port's own
:mod:`.integrity`); plans are the same JSON, so one plan drives either
package.

Production failure modes — a transient device error, a hung accelerator, a
corrupted checkpoint leaf, an operator SIGKILL mid-update — are injected
through named **sites** instrumented in the store / source / engine /
registry / controller.  Each site calls :func:`fire` with a little context;
when no plan is installed that is one global ``is None`` check, so the happy
path pays nothing measurable.

A :class:`FaultPlan` is a list of :class:`Fault` records, each bound to a
site and an occurrence index (``at`` = fire on the Nth event at that site,
for ``times`` consecutive events).  Plans are plain JSON, so the chaos
harness can pass one to a subprocess (``--chaos plan.json``) and every run
of the same plan injects the identical schedule — failures are part of the
test's seed, not of its luck.

Instrumented sites (context keys in parentheses):

====================== ====================================================
``engine.transform``    every :meth:`TransformEngine.transform` (``Z``)
``registry.activate``   every :meth:`ModelRegistry.activate` (``name``,
                        ``version``)
``store.committed``     every committed :func:`checkpoint.store.save`
                        (``path`` — corrupt-after-commit faults)
``shards.committed``    every :func:`write_shards` meta commit (``path``)
``shards.shard_written``each shard file written, BEFORE the meta commit
                        (``path`` — a SIGKILL here is a torn shard write)
``controller.*``        the continuous loop's phase transitions
                        (:mod:`repro_torch.launch.continuous_vi`):
                        ``update_start``, ``state_saved``, ``staged`` and
                        ``activated`` (``update``), each fired AFTER its
                        journal append, so a ``sigkill`` there is a crash
                        between durable transitions
====================== ====================================================

Actions: ``raise`` (a :class:`InjectedFault`), ``raise_transient``
(:class:`TransientEngineError` — the batcher's retry path), ``poison``
(raise :class:`PoisonRequestError` iff the request payload contains the
poison sentinel — content-bound, so batch bisection isolates exactly the
poison request), ``hang`` (sleep ``hang_ms``), ``sigkill`` (the process
dies mid-phase, no cleanup — the crash-recovery path), ``flip_bit`` /
``truncate`` (corrupt the file named by the event's context in place).
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from .integrity import flip_bit, truncate_file

#: Requests carrying this value in any cell are "poison": they deterministically
#: fail the device call they ride in, whatever batch they were coalesced into.
POISON_SENTINEL = 1.0e30


class InjectedFault(RuntimeError):
    """A chaos-plan fault (non-transient: retries must NOT paper over it)."""


class TransientEngineError(RuntimeError):
    """A transient engine/device failure — safe and expected to retry."""


class PoisonRequestError(RuntimeError):
    """A request whose *content* deterministically fails the device call."""


@dataclasses.dataclass
class Fault:
    """One scheduled fault: fires at occurrences ``[at, at + times)`` of
    ``site`` (1-based).  ``poison`` faults ignore ``at`` — they are bound to
    request content, not to event order."""

    site: str
    at: int = 1
    action: str = "raise"  # raise|raise_transient|poison|hang|sigkill|flip_bit|truncate
    times: int = 1
    hang_ms: float = 0.0
    byte_offset: int = 0
    bit: int = 0
    truncate_to: int = 0

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


class FaultPlan:
    """A deterministic fault schedule + per-site occurrence counters."""

    def __init__(self, faults: List[Fault]):
        self.faults = list(faults)
        self._counts: Dict[str, int] = {}
        self._lock = threading.Lock()
        self.fired: List[Dict] = []  # audit log: what actually triggered

    # -- (de)serialization --------------------------------------------------

    def to_json(self) -> str:
        return json.dumps({"faults": [f.to_dict() for f in self.faults]}, indent=1)

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        return cls([Fault(**f) for f in json.loads(text)["faults"]])

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.to_json())
        return path

    @classmethod
    def load(cls, path: str) -> "FaultPlan":
        with open(path) as f:
            return cls.from_json(f.read())

    # -- firing -------------------------------------------------------------

    def _matches(self, fault: Fault, count: int, ctx: Dict) -> bool:
        if fault.action == "poison":
            Z = ctx.get("Z")
            return Z is not None and bool(np.any(np.asarray(Z) == POISON_SENTINEL))
        return fault.at <= count < fault.at + fault.times

    def fire(self, site: str, **ctx) -> None:
        with self._lock:
            count = self._counts.get(site, 0) + 1
            self._counts[site] = count
            hits = [f for f in self.faults if f.site == site and self._matches(f, count, ctx)]
            for f in hits:
                self.fired.append({"site": site, "count": count, "action": f.action})
        for f in hits:
            self._execute(f, ctx)

    def _execute(self, fault: Fault, ctx: Dict) -> None:
        if fault.action == "raise":
            raise InjectedFault(f"injected fault at {fault.site} (#{fault.at})")
        if fault.action == "raise_transient":
            raise TransientEngineError(
                f"injected transient failure at {fault.site} (#{fault.at})"
            )
        if fault.action == "poison":
            raise PoisonRequestError(
                f"poison request payload at {fault.site} (sentinel {POISON_SENTINEL:g})"
            )
        if fault.action == "hang":
            time.sleep(fault.hang_ms / 1e3)
            return
        if fault.action == "sigkill":
            os.kill(os.getpid(), signal.SIGKILL)
            return  # pragma: no cover - unreachable
        path = ctx.get("path")
        if path is None:
            raise ValueError(
                f"fault action {fault.action!r} at site {fault.site!r} needs a "
                "path in the event context"
            )
        if fault.action == "flip_bit":
            target = _pick_file(path)
            flip_bit(target, fault.byte_offset, fault.bit)
            return
        if fault.action == "truncate":
            target = _pick_file(path)
            truncate_file(target, fault.truncate_to)
            return
        raise ValueError(f"unknown fault action {fault.action!r}")


def _pick_file(path: str) -> str:
    """File-corruption faults may point at a checkpoint *directory*; corrupt
    its largest payload file (the Gram accumulators, not the manifest)."""
    if os.path.isfile(path):
        return path
    candidates = [
        os.path.join(path, n) for n in sorted(os.listdir(path)) if n.endswith(".npy")
    ]
    if not candidates:
        raise ValueError(f"no corruptible payload files under {path!r}")
    return max(candidates, key=os.path.getsize)


# ---------------------------------------------------------------------------
# Global installation point (one process, one plan)
# ---------------------------------------------------------------------------

_PLAN: Optional[FaultPlan] = None


def install(plan: FaultPlan) -> FaultPlan:
    """Install ``plan`` as the process-wide fault schedule."""
    global _PLAN
    _PLAN = plan
    return plan


def uninstall() -> None:
    global _PLAN
    _PLAN = None


def installed() -> Optional[FaultPlan]:
    return _PLAN


def fire(site: str, **ctx) -> None:
    """Hook entry: a no-op (one global load + ``is None``) without a plan."""
    plan = _PLAN
    if plan is not None:
        plan.fire(site, **ctx)
