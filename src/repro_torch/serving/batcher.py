"""MicroBatcher: coalesce concurrent (FT) requests into one device call.

Counterpart of ``src/repro/serving/batcher.py``, the same policy and
failure handling line for line.  Callers submit variable-size transform /
predict requests from any thread; a single worker thread drains the queue,
concatenates the pending rows into one padded call through the
:class:`~repro_torch.serving.engine.TransformEngine` (which launches on its
own explicit device and returns host arrays: the copy back is the sync),
and scatters the result rows back to each caller's future.  Callers and the
worker share the interpreter lock, so with closed-loop clients in the same
process the latencies are host-bound.

Coalescing policy: the worker sleeps until a request arrives, then keeps
collecting until either ``max_batch_rows`` is reached or ``max_delay_ms``
has elapsed since the first queued request — classic micro-batching: tiny
added latency bound, large throughput win (one dispatch + one pad instead
of one per request).

Because the engine's evaluation is row-independent and the engine pads to
its row buckets anyway, a coalesced call is bit-identical to per-request
calls — batching is purely a throughput optimization.  That same
row-independence is what makes **failure isolation** sound: when a coalesced
call fails, the batch is bisected and each half re-dispatched, so a poison
request (one whose *content* deterministically fails the device call) ends
up failing alone while every innocent rider succeeds with bit-identical
output.  Transient engine failures
(:class:`~repro_torch.resilience.chaos.TransientEngineError`) are retried with
exponential backoff and deterministic, seeded jitter before isolation kicks
in.  Per-request deadlines bound how long a request may sit behind a
retrying batch: an expired request fails with :class:`DeadlineExceeded`
instead of holding its caller forever.  None of this touches the happy
path — with no faults, the dispatch sequence (and therefore every output
bit) is identical to the pre-resilience batcher.

``predict`` requests ride the same queue: they share the batched feature
transform and apply the (cheap, host-side) classifier head per request.

Shutdown is loss-free: ``stop()`` drains queued requests by default, and
anything still undrained (``drain=False``, or racing submitters) fails with
:class:`ShutdownError` — no future is ever silently dropped.  ``submit``
after ``stop()`` raises :class:`ShutdownError` instead of enqueueing into a
dead queue.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Callable, Deque, List, Optional, Sequence

import numpy as np

from .. import obs
from ..resilience.chaos import TransientEngineError
from .engine import TransformEngine


class ShutdownError(RuntimeError):
    """The batcher is (or went) stopped; the request was not served."""


class DeadlineExceeded(TimeoutError):
    """The request's deadline passed before it could be dispatched."""


@dataclasses.dataclass(frozen=True)
class BatcherConfig:
    max_batch_rows: int = 8192  # flush when this many rows are queued
    max_delay_ms: float = 2.0  # ... or this long after the first request
    max_queue: int = 4096  # pending-request backpressure bound
    # -- degrade-don't-die ---------------------------------------------------
    max_retries: int = 2  # transient-failure retries per batch
    backoff_ms: float = 1.0  # base of the exponential retry backoff
    backoff_jitter: float = 0.5  # jitter fraction on top (deterministic, seeded)
    retry_seed: int = 0  # seeds the backoff jitter: replays are exact
    isolate_failures: bool = True  # bisect failed batches to isolate poison
    default_deadline_ms: Optional[float] = None  # per-request default (None: none)

    def __post_init__(self):
        if self.max_batch_rows < 1:
            raise ValueError(f"max_batch_rows must be >= 1, got {self.max_batch_rows}")
        if self.max_delay_ms < 0:
            raise ValueError(f"max_delay_ms must be >= 0, got {self.max_delay_ms}")
        if self.max_queue < 1:
            # 0 would deadlock: submit waits for space the worker can never
            # create (it only notifies _not_full after popping a request)
            raise ValueError(f"max_queue must be >= 1, got {self.max_queue}")
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {self.max_retries}")
        if self.backoff_ms < 0:
            raise ValueError(f"backoff_ms must be >= 0, got {self.backoff_ms}")


@dataclasses.dataclass
class _Request:
    Z: np.ndarray
    kind: str  # 'transform' | 'predict'
    future: Future
    t_submit: float
    deadline: Optional[float] = None  # absolute perf_counter time


class MicroBatcher:
    """Request-coalescing front of a :class:`TransformEngine`.

    ``head`` (optional) maps a feature block ``(q, F)`` to predictions for
    ``kind='predict'`` requests — e.g. ``classifier.head`` (SVM argmax).

    Start the background worker with ``start()`` (or use the context
    manager); ``submit`` returns a ``concurrent.futures.Future``.  For
    deterministic in-process use (tests, benchmark replay without threads)
    ``run_once()`` drains the current queue synchronously in coalesced
    batches.
    """

    def __init__(
        self,
        engine: TransformEngine,
        *,
        head: Optional[Callable[[np.ndarray], np.ndarray]] = None,
        config: BatcherConfig = BatcherConfig(),
    ):
        self.engine = engine
        self.head = head
        self.config = config
        self._queue: Deque[_Request] = deque()
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self._stopped = False
        self._batch_seq = 0  # keys the deterministic retry jitter
        # obs metric primitives (always live — ``stats`` is a view over them)
        self._requests = obs.Counter()
        self._batches = obs.Counter()
        self._rows = obs.Counter()
        self._coalesced_max = obs.Gauge()
        self._retries = obs.Counter()
        self._bisections = obs.Counter()
        self._isolated_failures = obs.Counter()
        self._deadline_expired = obs.Counter()
        self._shutdown_failed = obs.Counter()
        # queue-wait sketch replaces the single running wait_ms_total scalar;
        # the view keeps the historical key as ``sum`` of the sketch
        self.wait_ms = obs.Histogram()

    @property
    def stats(self) -> dict:
        """Point-in-time metric view (same keys as the historical dict)."""
        return {
            "requests": self._requests.value,
            "batches": self._batches.value,
            "rows": self._rows.value,
            "coalesced_max": int(self._coalesced_max.value),
            "wait_ms_total": self.wait_ms.sum,
            "retries": self._retries.value,
            "bisections": self._bisections.value,
            "isolated_failures": self._isolated_failures.value,
            "deadline_expired": self._deadline_expired.value,
            "shutdown_failed": self._shutdown_failed.value,
            "wait_ms": self.wait_ms.summary(),
        }

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "MicroBatcher":
        if self._thread is not None:
            return self
        self._stopped = False
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self, drain: bool = True):
        """Stop the worker.  ``drain=True`` (default) serves queued requests
        synchronously first; any future still pending afterwards — or every
        queued future under ``drain=False`` — fails with
        :class:`ShutdownError` rather than being lost forever."""
        with self._lock:
            self._running = False
            self._stopped = True
            self._not_empty.notify_all()
            self._not_full.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if drain:
            self.run_once()  # serve stragglers synchronously
        with self._lock:
            leftovers = list(self._queue)
            self._queue.clear()
        for r in leftovers:
            self._shutdown_failed.inc()
            if r.future.set_running_or_notify_cancel():
                r.future.set_exception(
                    ShutdownError("MicroBatcher stopped before serving this request")
                )

    def __enter__(self) -> "MicroBatcher":
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- client API --------------------------------------------------------

    def submit(self, Z, kind: str = "transform", *, deadline_ms: Optional[float] = None) -> Future:
        """Enqueue one request; the future resolves to (q, F) features for
        ``kind='transform'`` or head outputs for ``kind='predict'``.

        ``deadline_ms`` (default ``config.default_deadline_ms``) bounds the
        time from submit to dispatch: a request still queued past its
        deadline fails with :class:`DeadlineExceeded` instead of waiting out
        a retry storm."""
        if kind not in ("transform", "predict"):
            raise ValueError(f"unknown request kind {kind!r}")
        if kind == "predict" and self.head is None:
            raise ValueError("predict requests need a head= callable")
        Z = np.asarray(Z)
        n = self.engine.consts.n
        if Z.ndim != 2 or Z.shape[1] != n:
            # reject malformed requests HERE: once coalesced, a bad request
            # would fail the whole batch and poison innocent callers' futures
            raise ValueError(f"expected (q, {n}) request rows, got {Z.shape}")
        t_submit = time.perf_counter()
        if deadline_ms is None:
            deadline_ms = self.config.default_deadline_ms
        deadline = None if deadline_ms is None else t_submit + deadline_ms / 1e3
        fut: Future = Future()
        req = _Request(Z=Z, kind=kind, future=fut, t_submit=t_submit, deadline=deadline)
        with self._lock:
            while (
                not self._stopped
                and self._running
                and len(self._queue) >= self.config.max_queue
            ):
                self._not_full.wait()
            if self._stopped:
                # after stop()'s final drain nothing empties the queue;
                # enqueueing would leave the caller blocked on a future that
                # never resolves (including submitters woken from the
                # backpressure wait above by stop())
                raise ShutdownError("MicroBatcher is stopped; start() it again")
            self._queue.append(req)
            self._requests.inc()
            self._not_empty.notify()
        return fut

    def transform(self, Z, *, deadline_ms: Optional[float] = None) -> np.ndarray:
        """Synchronous convenience: submit + wait."""
        fut = self.submit(Z, "transform", deadline_ms=deadline_ms)
        if self._thread is None:
            self.run_once()
        return fut.result()

    def predict(self, Z, *, deadline_ms: Optional[float] = None) -> np.ndarray:
        fut = self.submit(Z, "predict", deadline_ms=deadline_ms)
        if self._thread is None:
            self.run_once()
        return fut.result()

    # -- batching core -----------------------------------------------------

    def _take_batch(self, block: bool) -> List[_Request]:
        """Pop a coalesced batch: up to ``max_batch_rows`` rows, waiting at
        most ``max_delay_ms`` after the first pending request."""
        with self._lock:
            if block:
                while not self._queue and self._running:
                    self._not_empty.wait()
            if not self._queue:
                return []
            # anchor the flush deadline at the OLDEST pending request, so a
            # request that already waited while the previous batch was being
            # processed is not taxed another full delay window
            deadline = self._queue[0].t_submit + self.config.max_delay_ms / 1e3
            # collection window: give concurrent submitters a bounded chance
            # to join this batch.  A timed condition wait (woken by submit)
            # rather than a sleep/poll loop — the worker stays off the GIL
            # while it waits.
            while self._running:
                rows = sum(r.Z.shape[0] for r in self._queue)
                if rows >= self.config.max_batch_rows:
                    break
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                self._not_empty.wait(timeout=remaining)
            batch: List[_Request] = []
            rows = 0
            while self._queue:
                nxt = self._queue[0]
                if batch and rows + nxt.Z.shape[0] > self.config.max_batch_rows:
                    break
                batch.append(self._queue.popleft())
                rows += nxt.Z.shape[0]
            self._not_full.notify_all()
        return batch

    def _backoff_s(self, attempt: int) -> float:
        """Exponential backoff with deterministic jitter: replaying the same
        fault schedule reproduces the same retry timing, so chaos runs are
        seeds, not dice."""
        base = self.config.backoff_ms * (2.0 ** attempt) / 1e3
        rng = np.random.default_rng(
            np.random.SeedSequence([self.config.retry_seed, self._batch_seq, attempt])
        )
        return base * (1.0 + self.config.backoff_jitter * float(rng.uniform()))

    def _fail(self, batch: Sequence[_Request], err: BaseException):
        for r in batch:
            if r.future.set_running_or_notify_cancel():
                r.future.set_exception(err)

    def _scatter(self, batch: Sequence[_Request], Z: np.ndarray, feats: np.ndarray, t0: float):
        self._batches.inc()
        self._rows.inc(int(Z.shape[0]))
        self._coalesced_max.set_max(len(batch))
        self.wait_ms.observe((t0 - batch[0].t_submit) * 1e3)
        start = 0
        for r in batch:
            stop = start + r.Z.shape[0]
            block = feats[start:stop]
            if len(batch) > 1:
                # own the rows: a view would pin the whole coalesced batch
                # buffer in memory for as long as any caller keeps its result
                block = np.ascontiguousarray(block)
            start = stop
            if not r.future.set_running_or_notify_cancel():
                continue
            try:
                if r.kind == "predict":
                    r.future.set_result(self.head(block))
                else:
                    r.future.set_result(block)
            except Exception as e:
                r.future.set_exception(e)

    def _execute(self, batch: Sequence[_Request]):
        """Dispatch one coalesced batch: transient failures retry with
        backoff; a persistent failure bisects the batch so the offending
        request(s) fail alone.  Single-request batches fail directly — the
        recursion's base case, depth <= ceil(log2(len(batch)))."""
        t0 = time.perf_counter()
        Z = (
            np.concatenate([r.Z for r in batch], axis=0)
            if len(batch) > 1
            else batch[0].Z
        )
        with obs.span("batcher/execute", requests=len(batch), rows=int(Z.shape[0])):
            attempt = 0
            while True:
                try:
                    feats = self.engine.transform(Z)
                    break
                except TransientEngineError as e:
                    if attempt >= self.config.max_retries:
                        # the engine, not a request, is sick: isolation cannot
                        # help, and hammering it further only extends the outage
                        self._fail(batch, e)
                        return
                    self._retries.inc()
                    obs.event("batcher/retry", attempt=attempt, rows=int(Z.shape[0]))
                    time.sleep(self._backoff_s(attempt))
                    attempt += 1
                except Exception as e:
                    if self.config.isolate_failures and len(batch) > 1:
                        # bisect: row-independence means re-dispatching halves is
                        # bit-identical for every non-poison request in them
                        self._bisections.inc()
                        obs.event("batcher/bisect", requests=len(batch))
                        mid = len(batch) // 2
                        self._execute(batch[:mid])
                        self._execute(batch[mid:])
                    else:
                        if len(batch) == 1:
                            self._isolated_failures.inc()
                            obs.event("batcher/isolated_failure")
                        self._fail(batch, e)
                    return
            self._scatter(batch, Z, feats, t0)

    def _process(self, batch: Sequence[_Request]):
        if not batch:
            return
        now = time.perf_counter()
        live: List[_Request] = []
        for r in batch:
            if r.deadline is not None and now > r.deadline:
                self._deadline_expired.inc()
                obs.event("batcher/deadline_expired")
                if r.future.set_running_or_notify_cancel():
                    r.future.set_exception(
                        DeadlineExceeded(
                            f"request waited {(now - r.t_submit) * 1e3:.1f}ms, "
                            "past its deadline, before dispatch"
                        )
                    )
                continue
            live.append(r)
        if live:
            self._batch_seq += 1
            self._execute(live)

    def run_once(self) -> int:
        """Synchronously drain the queue in coalesced batches (no worker
        thread needed).  Returns the number of requests processed."""
        done = 0
        while True:
            batch = self._take_batch(block=False)
            if not batch:
                return done
            self._process(batch)
            done += len(batch)

    def _loop(self):
        while True:
            with self._lock:
                if not self._running and not self._queue:
                    return
            batch = self._take_batch(block=True)
            self._process(batch)
