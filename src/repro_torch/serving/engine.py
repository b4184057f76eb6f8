"""TransformEngine: shape-bucketed (FT) serving on one device.

Counterpart of ``src/repro/serving/engine.py``.  One engine owns one model
set (the per-class models of a classifier, or a single model) and the
fused evaluation plan built from it by :func:`repro_torch.api._fuse`, with
its constants moved to the engine's device once
(:func:`repro_torch.api.plan_constants`).  Every device call evaluates
through :func:`repro_torch.api.eval_with_constants` and nothing else, the
body of the direct :func:`repro_torch.api.feature_transform`: on every
device its final product is summed term by term in one fixed order
(``api._row_stable_product``), so a row's bits do not depend on the other
rows of the call.

A query of ``q`` rows is zero-padded up to a **pow2 row bucket** (clamped to
``[min_bucket, max_bucket]``); larger queries stream through in full
``max_bucket`` chunks.  Padding rows changes nothing about real rows, so
the sliced result is bit-identical to the direct transform of the same rows
on the same device.

Eager PyTorch compiles nothing, but the reference's accounting stays: a
bucket's first device call allocates its blocks in the caching allocator,
:meth:`TransformEngine.warmup` makes that call for every bucket before
traffic arrives, and a **recompile** is the first call at a bucket that
warm-up did not reach.  After a full warm-up, a trace of any size mix runs
with ``stats["recompiles"] == 0``.  ``compile_seconds`` counts kernel
builds (:mod:`repro_torch.obs.device`); the serving call launches no
hand-written kernel, so it stays 0.

Device calls are made with the engine's explicit device (its index fixed at
construction), so a worker thread needs no current-device setup; the copy
back to the host (``.cpu()``) is the synchronization before results reach
the caller.  The sharded engine (``mesh=``) is ROADMAP.md queue 1 item 12b.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _device, obs
from ..core.oavi import pow2_bucket
from ..resilience import chaos

_SHARDED = "the sharded serving engine (mesh=) is not ported yet: ROADMAP.md queue 1 item 12b"


class UnsupportedModelError(TypeError):
    """The model set has no fused term-book plan (e.g. VCA) — serve those
    through the per-model loop instead."""


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Row-bucket policy of a :class:`TransformEngine`.

    ``min_bucket`` bounds the padding waste of tiny requests from below
    (every request costs at least one ``min_bucket``-row device call);
    ``max_bucket`` bounds device memory from above — larger queries stream
    through in full ``max_bucket`` chunks (already-warm buckets).
    """

    min_bucket: int = 64
    max_bucket: int = 16_384  # larger requests chunk through warm buckets

    def __post_init__(self):
        if self.min_bucket < 1 or self.max_bucket < self.min_bucket:
            raise ValueError(
                f"need 1 <= min_bucket <= max_bucket, got "
                f"({self.min_bucket}, {self.max_bucket})"
            )


def bucket_work(b: int, L: int, k: int, n: int, itemsize: int) -> Dict:
    """Work of one ``b``-row call of the fused (FT) over a book of ``L``
    terms (the constant included) and ``k`` features, from
    :func:`repro_torch.api.eval_with_constants`: the wavefront products
    (``L - 1`` a row), the leading terms (``k``), the generator product
    (``2 L k - k``: ``k`` products for the first term, a multiply-add per
    feature for each of the other ``L - 1``) and the leading terms' add
    (``k``), so ``b * (2 L k + L + k - 1)`` flops; bytes: the query read,
    the constants read, the features written, each once."""
    return {
        "flops": float(b) * (2.0 * L * k + L + k - 1),
        "bytes_accessed": float(itemsize) * (b * n + L * k + 2 * k + b * k),
        "bytes_out": float(itemsize) * b * k,
    }


class TransformEngine:
    """Serve the fused feature transform of one model set.

    Parameters
    ----------
    models : the per-class model set (term-book models only — OAVI / ABM).
    device : where the constants live and every call runs; ``None`` means
        the CUDA card (and raises without one), ``"cpu"`` only when asked.
    mesh : the reference's sharded engine; raises
        :class:`NotImplementedError` (ROADMAP.md queue 1 item 12b).
    config : row-bucket policy (:class:`EngineConfig`).
    """

    def __init__(
        self,
        models: Sequence,
        *,
        device=None,
        mesh=None,
        config: EngineConfig = EngineConfig(),
    ):
        from .. import api

        if mesh is not None:
            raise NotImplementedError(_SHARDED)
        dev = _device.resolve(device)
        if dev.type == "cuda" and dev.index is None:
            # fix the index now: a worker thread's current device is not ours
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.models: Tuple = tuple(models)
        self._model_key = tuple(id(m) for m in self.models)
        plan = api._fuse(self.models)
        if plan is None:
            raise UnsupportedModelError(
                "TransformEngine needs term-book models (OAVI/ABM); got a "
                "model set with no fused plan (e.g. VCA or mixed dtypes) — "
                "use repro_torch.api.feature_transform's per-model fallback"
            )
        self.plan = plan
        self.consts = api.plan_constants(plan, dev)
        self.terms = int(plan.parents.shape[0])  # L: the fused book, constant included
        self.config = config
        self.min_bucket = pow2_bucket(config.min_bucket)
        self.max_bucket = max(pow2_bucket(config.max_bucket), self.min_bucket)
        self._seen_buckets: set = set()
        self._lock = threading.Lock()
        self.backend = "local"
        # obs metric primitives (always live — ``stats`` is a view over them;
        # the span/trace layer is what OBS_ENABLED gates)
        self._requests = obs.Counter()
        self._rows = obs.Counter()
        self._device_calls = obs.Counter()
        self._padded_rows = obs.Counter()
        self._recompiles = obs.Counter()
        self._warmup_compiles = obs.Counter()
        self._bucket_calls: Dict[int, obs.Counter] = {}
        # per-engine request latency sketch, also folded into the
        # process-global serve SLO histogram by label
        self.latency = obs.Histogram()
        self._slo = obs.registry().histogram("serve.transform_seconds", backend=self.backend)
        self._compile_seconds = 0.0

    @property
    def stats(self) -> Dict:
        """Point-in-time counter view (the reference's keys)."""
        lat = self.latency.summary()
        with self._lock:
            seen = sorted(self._seen_buckets)
            buckets = {b: c.value for b, c in sorted(self._bucket_calls.items())}
        dispatched = sum(n * self._bucket_flops(b) for b, n in buckets.items())
        achieved = None
        if dispatched > 0.0 and lat["sum"] > 0.0:
            achieved = round(dispatched / lat["sum"] / 1e9, 3)
        return {
            "requests": self._requests.value,
            "rows": self._rows.value,
            "device_calls": self._device_calls.value,
            "padded_rows": self._padded_rows.value,
            "recompiles": self._recompiles.value,
            "warmup_compiles": self._warmup_compiles.value,
            "buckets": buckets,
            "latency": lat,
            "flops_per_bucket": {b: self._bucket_flops(b) for b in seen},
            "flops_dispatched": dispatched,
            "compile_seconds": round(self._compile_seconds, 6),
            "achieved_gflops": achieved,
        }

    # -- bucket machinery ---------------------------------------------------

    def matches(self, models: Sequence) -> bool:
        """True when this engine serves exactly ``models`` (by identity)."""
        return tuple(id(m) for m in models) == self._model_key

    def bucket_for(self, q: int) -> int:
        """Row bucket a ``q``-row request pads to (pow2, clamped)."""
        return min(max(pow2_bucket(max(q, 1)), self.min_bucket), self.max_bucket)

    def buckets(self) -> Tuple[int, ...]:
        """Every bucket this engine can dispatch (smallest to largest)."""
        out = []
        b = self.min_bucket
        while b < self.max_bucket:
            out.append(b)
            b = pow2_bucket(b + 1)
        out.append(self.max_bucket)
        return tuple(out)

    # -- execution ----------------------------------------------------------

    def _bucket_flops(self, b: int) -> float:
        """Flops of one ``b``-row device call (:func:`bucket_work`)."""
        return bucket_work(b, self.terms, self.consts.num_features, self.consts.n,
                           self.plan.dtype.itemsize)["flops"]

    def _call(self, Zp: np.ndarray) -> np.ndarray:
        """One padded device call: copy in, evaluate, copy back (the sync)."""
        from .. import api

        Zt = torch.from_numpy(Zp).to(self.device)
        return api.eval_with_constants(self.consts, Zt).cpu().numpy()

    def warmup(self, max_rows: Optional[int] = None) -> int:
        """One call at every bucket up to ``max_rows`` (default: all), so the
        caching allocator holds each bucket's blocks before traffic arrives.

        Returns the number of buckets warmed.  After a full warm-up a request
        trace of any shape mix runs with ``stats["recompiles"] == 0``.
        """
        top = self.max_bucket if max_rows is None else self.bucket_for(max_rows)
        warmed = 0
        with obs.device.profile_window("serve/warmup"):
            for b in self.buckets():
                if b > top:
                    break
                with self._lock:
                    if b in self._seen_buckets:
                        continue
                    self._seen_buckets.add(b)
                Zb = np.zeros((b, self.consts.n), self.plan.dtype)
                with obs.span("serve/warmup_compile", bucket=b, backend=self.backend), \
                        obs.device.CompileWindow() as cw:
                    self._call(Zb)
                with self._lock:
                    self._compile_seconds += cw.seconds
                warmed += 1
        self._warmup_compiles.inc(warmed)
        return warmed

    def _dispatch(self, Zp: np.ndarray) -> np.ndarray:
        """One padded device call at a bucket shape; updates the stats."""
        b = Zp.shape[0]
        fresh = False
        with self._lock:
            if b not in self._seen_buckets:
                self._seen_buckets.add(b)
                self._recompiles.inc()
                fresh = True
                obs.event("serve/recompile", bucket=b, backend=self.backend)
            bucket = self._bucket_calls.get(b)
            if bucket is None:
                bucket = self._bucket_calls.setdefault(b, obs.Counter())
        self._device_calls.inc()
        bucket.inc()
        if not fresh:
            return self._call(Zp)
        with obs.device.CompileWindow() as cw:
            out = self._call(Zp)
        with self._lock:
            self._compile_seconds += cw.seconds
        return out

    def transform(self, Z) -> np.ndarray:
        """(FT) features for one request: (q, num_features) in plan dtype.

        Bit-identical to ``api.feature_transform(self.models, Z)`` on the
        engine's device for any q; rows beyond ``max_bucket`` stream
        through in full already-warm chunks.
        """
        Z = np.asarray(Z)
        if Z.ndim != 2 or Z.shape[1] != self.consts.n:
            raise ValueError(f"expected (q, {self.consts.n}) queries, got {Z.shape}")
        # chaos hook: transient/poison/hang faults fire HERE, the device-call
        # boundary — the batcher's retry and bisection paths see exactly what
        # a failing accelerator call would look like (no-op without a plan)
        chaos.fire("engine.transform", Z=Z)
        q = Z.shape[0]
        self._requests.inc()
        self._rows.inc(q)
        out_dtype = self.plan.dtype
        if q == 0 or self.consts.num_features == 0:
            return np.zeros((q, self.consts.num_features), out_dtype)
        t0 = time.perf_counter()
        with obs.span("serve/transform", rows=q, backend=self.backend):
            Zd = Z.astype(self.plan.dtype, copy=False)
            out = np.empty((q, self.consts.num_features), out_dtype)
            start = 0
            while start < q:
                stop = min(start + self.max_bucket, q)
                chunk = Zd[start:stop]
                b = self.bucket_for(chunk.shape[0])
                if chunk.shape[0] < b:
                    Zp = np.zeros((b, self.consts.n), self.plan.dtype)
                    Zp[: chunk.shape[0]] = chunk
                    self._padded_rows.inc(b - chunk.shape[0])
                else:
                    Zp = np.ascontiguousarray(chunk)
                out[start:stop] = self._dispatch(Zp)[: chunk.shape[0]]
                start = stop
        dur = time.perf_counter() - t0
        self.latency.observe(dur)
        self._slo.observe(dur)
        return out

    def __repr__(self) -> str:
        return (
            f"TransformEngine(models={len(self.models)}, "
            f"features={self.consts.num_features}, terms={self.terms}, "
            f"device={self.device}, buckets=[{self.min_bucket}..{self.max_bucket}])"
        )
