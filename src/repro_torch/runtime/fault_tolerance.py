"""Fault-tolerant training runtime: checkpoint-restart, stragglers, resume.

Counterpart of ``src/repro/runtime/fault_tolerance.py``, on the port's
:mod:`repro_torch.checkpoint.store` (``AsyncSaver``, ``restore``):

* :class:`TrainLoop` -- the driver loop with periodic async checkpointing,
  automatic resume from the newest *verifiable* committed step, bounded
  retry on step failure (then a restore from the checkpoint), and a
  failure-injection hook used by the tests.
* **straggler detection** -- a step-time EWMA with a configurable multiple
  threshold; a step slower than that is logged and recorded.  Data-level
  mitigation stays deterministic: the pipeline is keyed by (seed, step).
* **re-placement** -- checkpoints are unsharded at rest; :func:`reshard_tree`
  puts a restored tree's leaves on the devices given (one device, or a tree
  of them), as the reference re-``device_put``s under a new mesh.

Where the reference's restored leaves are arrays that work from the host,
the port's step functions take tensors: a resume with ``shardings=None``
puts each tensor leaf back on the device its counterpart in the current
state lies on.

On several ranks (``sharding``, a
:class:`~repro_torch.runtime.data_parallel.DataParallelPlan` of more than
one rank) the state holds each rank's blocks of the leaves cut over the
data and model axes.  A checkpoint gathers them leaf by leaf on every rank
(a packed matrix -- SwiGLU, Mamba's and the mLSTM's ``[x | z]``, the sLSTM's
4 gates -- back in the one-device column order, an mLSTM head projection's
heads in order; 8-bit moments are whole on every rank already) and the
mesh's first rank alone writes it, in the one-device format (so a run
resumes on any mesh); a resume reads it on every rank and cuts each rank's
blocks.  A ``StepFailure`` then ends the run at once: a retry on one rank
alone would leave the ranks' collectives out of step.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Dict, Optional

import torch

from ..checkpoint import store
from ..resilience.integrity import IntegrityError

log = logging.getLogger("repro_torch.runtime")


@dataclasses.dataclass
class TrainLoopConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    keep_last: int = 3
    max_retries_per_step: int = 2
    straggler_ewma: float = 0.9
    straggler_factor: float = 3.0  # step slower than factor x EWMA -> flag
    max_steps: int = 1000


class StepFailure(RuntimeError):
    pass


def _placement(tree):
    """The devices of ``tree``'s tensor leaves, as a tree :func:`reshard_tree`
    takes (``None`` where a leaf is not a tensor)."""
    if isinstance(tree, dict):
        return {k: _placement(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_placement(v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    return tree.device if torch.is_tensor(tree) else None


def _sync(tree) -> None:
    """Wait for the card when the tree's first leaf lives there (the
    reference's ``block_until_ready`` on its first leaf)."""
    leaves = store._flatten(tree)[1]
    if leaves and torch.is_tensor(leaves[0]) and leaves[0].device.type == "cuda":
        torch.cuda.synchronize(leaves[0].device)


class TrainLoop:
    """Drives ``step_fn(state, batch) -> (state, metrics)`` with fault
    tolerance.  ``state`` is any tree (params + optimizer + pipeline step).
    """

    def __init__(
        self,
        config: TrainLoopConfig,
        step_fn: Callable,
        batch_fn: Callable[[int], Any],
        state: Any,
        failure_injector: Optional[Callable[[int], None]] = None,
        sharding=None,
    ):
        self.config = config
        self.sharding = sharding if sharding is not None and sharding.ranks > 1 else None
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.state = state
        self.failure_injector = failure_injector
        self.saver = store.AsyncSaver()
        self.step = 0
        self.metrics_history: list = []
        self.straggler_events: list = []
        self.restarts = 0
        self.integrity_fallbacks = 0
        self._ewma: Optional[float] = None

    # -- checkpoint-restart ------------------------------------------------

    def try_resume(self, shardings=None) -> bool:
        """Resume from the newest *verifiable* committed checkpoint.

        A head checkpoint corrupted after commit is detected by the
        manifest-v2 leaf checksums and skipped: resume lands on the previous
        committed step.  ``integrity_fallbacks`` counts the skipped steps.
        ``shardings`` places the restored leaves (:func:`reshard_tree`);
        ``None`` places each where the current state's leaf lies."""
        if shardings is None:
            shardings = _placement(self.state)
        steps = store.committed_steps(self.config.ckpt_dir)
        for latest in reversed(steps):
            try:
                if self.sharding is None:
                    self.state, meta = store.restore(
                        self.config.ckpt_dir, latest, self.state, shardings
                    )
                else:
                    tree, meta = store.restore(self.config.ckpt_dir, latest, self.state)
                    self.state = store.place(self.sharding.shard_state(tree), shardings)
            except IntegrityError as e:
                self.integrity_fallbacks += 1
                log.warning("checkpoint step %d is corrupt (%s); trying older", latest, e)
                continue
            self.step = latest
            log.info("resumed from step %d", latest)
            return True
        return False

    def _checkpoint(self):
        tree = self.state if self.sharding is None else self.sharding.full_state(self.state)
        if self.sharding is None or self.sharding.writer:
            self.saver.save(self.config.ckpt_dir, self.step, tree)
            store.cleanup(self.config.ckpt_dir, self.config.keep_last)

    # -- main loop -----------------------------------------------------------

    def run(self, num_steps: Optional[int] = None) -> Dict:
        target = self.step + (num_steps or self.config.max_steps)
        while self.step < target:
            batch = self.batch_fn(self.step)
            retries = 0
            while True:
                t0 = time.perf_counter()
                try:
                    if self.failure_injector is not None:
                        self.failure_injector(self.step)
                    self.state, metrics = self.step_fn(self.state, batch)
                    _sync(self.state)
                    break
                except StepFailure:
                    if self.sharding is not None:
                        raise
                    retries += 1
                    self.restarts += 1
                    if retries > self.config.max_retries_per_step:
                        # unrecoverable in-process: resume from checkpoint
                        log.warning("step %d failed %d times; restoring", self.step, retries)
                        if not self.try_resume():
                            raise
                        batch = self.batch_fn(self.step)
                        retries = 0
            dt = time.perf_counter() - t0
            self._track_straggler(dt)
            self.metrics_history.append(metrics)
            self.step += 1
            if self.step % self.config.ckpt_every == 0:
                self._checkpoint()
        self._checkpoint()
        self.saver.wait()
        if self.sharding is not None:  # every rank resumes only from a finished save
            self.sharding.barrier()
        return {
            "final_step": self.step,
            "restarts": self.restarts,
            "straggler_events": self.straggler_events,
        }

    def _track_straggler(self, dt: float):
        if self._ewma is None:
            self._ewma = dt
            return
        if dt > self.config.straggler_factor * self._ewma:
            self.straggler_events.append({"step": self.step, "dt": dt, "ewma": self._ewma})
            log.warning("straggler at step %d: %.3fs vs EWMA %.3fs", self.step, dt, self._ewma)
        a = self.config.straggler_ewma
        self._ewma = a * self._ewma + (1 - a) * dt


def reshard_tree(tree, shardings):
    """Put a (host or elsewhere placed) tree's leaves on new devices -- the
    elastic-resume primitive (:func:`repro_torch.checkpoint.store.place`)."""
    return store.place(tree, shardings)
