"""Out-of-core OAVI: fit over data that never fully resides on the device.

Counterpart of ``src/repro/streaming/fit.py``.  Every decision of an OAVI
degree reduces to the Gram statistics ``A^T B`` and ``B^T B``; the
evaluation matrix A enters through nothing else.  So the fit never holds A:

* **A rebuilt per chunk.**  A column of A is the evaluation of an O term, so
  for each ``chunk_rows``-row chunk of X the chunk's A-block is rebuilt from
  the term book's wavefront schedule (:class:`ChunkAccumulator`, through
  :func:`repro_torch.core.oavi.apply_wavefronts`).  It multiplies parent
  column by variable column, the same product the in-memory fit writes
  into A, so the block has the in-memory A's bits.
* **Gram statistics folded chunk by chunk** through
  :func:`repro_torch.kernels.ops.gram_accumulate` with a carry: one launch
  of the hand-written ``gram_update_acc`` kernel per chunk on the card, the
  plain blocked version on the CPU.  Both sum fixed ``GRAM_BLOCK``-row
  blocks and fold them onto the carry left to right, so for any chunk that
  is a multiple of ``GRAM_BLOCK`` the folded statistics equal the in-memory
  fit's one call bit for bit, and the streamed fit is the in-memory fit at
  matched capacity.
* **The degree's decisions from the statistics alone**:
  :func:`repro_torch.core.oavi.stats_step` (one class, the fast engine's
  ``ihb_degree`` launch or the eager candidate loop), and
  :func:`~repro_torch.core.oavi.stats_step_batched` for k classes
  (:func:`fit_classes`).

Chunks are read, permuted and zero-padded on the host, on a worker thread one
chunk ahead of the fold (:func:`prefetch_map`), and copied to the device by
the folding thread.  Peak device memory is O(chunk_rows * Lcap + Lcap^2)
whatever ``m`` is.

Not ported: the sharded streaming fit (``mesh=``, ROADMAP.md queue 1 item
12), the observability spans and cost sampling (item 13a); the reference's
recompile accounting has no counterpart, as eager PyTorch compiles nothing.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import _device
from ..core import ihb as ihb_mod
from ..core import oracles
from ..core import terms as terms_mod
from ..core.oavi import (
    Generator,
    OAVIConfig,
    OAVIModel,
    apply_wavefronts,
    border_index_arrays,
    check_config,
    class_batchable,
    collect_degree,
    finish_fit_stats,
    pow2_bucket,
    stats_step,
    wavefront_schedule,
)
from ..core.ordering import pearson_order_from_moments
from ..kernels import ops as kernel_ops
from .source import DataSource, as_source, iter_chunks

DEFAULT_CHUNK_ROWS = 4096
_SHARDED = "sharded streaming (mesh=) is not ported yet: ROADMAP.md queue 1 item 12"


def _check_chunk_rows(chunk_rows: int) -> int:
    chunk_rows = int(chunk_rows)
    if chunk_rows < kernel_ops.GRAM_BLOCK or chunk_rows & (chunk_rows - 1):
        raise ValueError(
            f"chunk_rows must be a power of two >= {kernel_ops.GRAM_BLOCK} "
            f"(the canonical Gram block), got {chunk_rows}"
        )
    return chunk_rows


def pearson_moments(
    source: DataSource,
    chunk_rows: int,
    start: int = 0,
    stop: Optional[int] = None,
    s1: Optional[np.ndarray] = None,
    s2: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Fold rows ``[start, stop)`` of ``source`` into the float64 Pearson
    sufficient statistics ``(s1, s2) = (sum x, sum x x^T)``: the one-pass
    state behind :func:`streaming_pearson_order`, which an online fit keeps
    so that an update folds only the new rows."""
    n = source.num_features
    s1 = np.zeros((n,), np.float64) if s1 is None else np.array(s1, np.float64)
    s2 = np.zeros((n, n), np.float64) if s2 is None else np.array(s2, np.float64)
    for chunk, valid in iter_chunks(source, chunk_rows, start=start, stop=stop):
        rows = np.asarray(chunk[:valid], np.float64)
        s1 += rows.sum(axis=0)
        s2 += rows.T @ rows
    return s1, s2


def streaming_pearson_order(
    source: DataSource, chunk_rows: int, reverse: bool = False
) -> np.ndarray:
    """One streaming pass of float64 moments -> the Pearson feature order
    (Algorithm 5).  It can differ from the two-pass in-memory order only at
    near-exact score ties (:func:`~repro_torch.core.ordering.
    pearson_scores_from_moments`)."""
    s1, s2 = pearson_moments(source, chunk_rows)
    return pearson_order_from_moments(s1, s2, source.num_rows, reverse=reverse)


def prefetch_map(stage, items: Iterable, enabled: bool = True):
    """Yield ``stage(item)`` for each item, with ONE staged result in flight
    ahead of the consumer: a worker thread stages item ``i + 1`` while the
    consumer folds item ``i``.  Order is kept and every item is staged once,
    so the consumer sees the same values with prefetching on or off."""
    if not enabled:
        for item in items:
            yield stage(item)
        return
    with ThreadPoolExecutor(max_workers=1) as pool:
        pending = None
        for item in items:
            nxt = pool.submit(stage, item)
            if pending is not None:
                yield pending.result()
            pending = nxt
        if pending is not None:
            yield pending.result()


# ---------------------------------------------------------------------------
# Chunk accumulator: rebuild the A-block, fold its Gram blocks onto the carry
# ---------------------------------------------------------------------------


class ChunkAccumulator:
    """Folds row chunks into one degree's Gram accumulators for one term
    book: the reference's jitted ``_chunk_accumulator`` in eager ops.

    A call rebuilds the chunk's A-block from the book's wavefront schedule
    (index tensors moved to the device once, here), multiplies every column
    by the row mask (padded rows are zero in every column, the constant one
    too; real rows multiply by exactly 1.0), pads it with zero columns to
    ``Lcap`` and folds both Gram blocks onto the carry through
    :func:`repro_torch.kernels.ops.gram_accumulate`.
    """

    def __init__(self, book: terms_mod.TermBook, Lcap: int, chunk_rows: int, device):
        dev = torch.device(device)
        waves, perm = wavefront_schedule(book.parents, book.vars)
        self.waves = tuple((torch.as_tensor(p, device=dev), torch.as_tensor(v, device=dev))
                           for p, v in waves)
        self.perm = None if perm is None else torch.as_tensor(perm, device=dev)
        self.pad = Lcap - len(book)
        self.rows = torch.arange(chunk_rows, device=dev)

    def __call__(self, acc, Xc: torch.Tensor, valid: int, parents, vars_):
        cols = apply_wavefronts(Xc, self.waves, self.perm)
        cols = cols * (self.rows < valid).to(Xc.dtype)[:, None]
        A = F.pad(cols, (0, self.pad))
        return kernel_ops.gram_accumulate(A, Xc, parents, vars_, acc=acc)


def accumulate_source_range(
    acc_fn: ChunkAccumulator,
    source: DataSource,
    start: int,
    stop: int,
    chunk_rows: int,
    acc: Tuple[torch.Tensor, torch.Tensor],
    parents: torch.Tensor,
    vars_: torch.Tensor,
    perm: Optional[np.ndarray] = None,
    np_dtype=np.float32,
    prefetch: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Fold rows ``[start, stop)`` of ``source`` into the accumulators
    ``acc`` (on the device the chunks go to).

    ``start`` must sit on a :data:`~repro_torch.kernels.ops.GRAM_BLOCK`
    boundary of the global row index: every chunk then covers whole blocks
    (trailing zero rows add exact zeros), so the block partition, and every
    fp32 partial, is that of one pass over ``[0, stop)`` wherever the range
    is split.  An online update resumes a saved fold this way
    (:mod:`repro_torch.online`).  Each chunk is staged in a fresh host
    buffer and copied to the device by this thread.  Returns ``(accQL, accC,
    num_chunks)``."""
    if start % kernel_ops.GRAM_BLOCK:
        raise ValueError(
            f"range start {start} is not a multiple of the Gram block "
            f"({kernel_ops.GRAM_BLOCK}); the blocked fp32 reduction would "
            "not match a one-shot pass bit for bit"
        )
    n = source.num_features
    dev = acc[0].device

    def stage(lo: int):
        hi = min(lo + chunk_rows, stop)
        rows = np.zeros((chunk_rows, n), np_dtype)
        block = np.asarray(source.read(lo, hi))
        if perm is not None:
            block = block[:, perm]
        rows[: hi - lo] = block
        return torch.from_numpy(rows), hi - lo

    num_chunks = 0
    for rows, valid in prefetch_map(stage, range(start, stop, chunk_rows), enabled=prefetch):
        acc = acc_fn(acc, rows.to(dev), valid, parents, vars_)
        num_chunks += 1
    return acc[0], acc[1], num_chunks


# ---------------------------------------------------------------------------
# The streaming fit
# ---------------------------------------------------------------------------


def new_stats(m: int, n: int, chunk_rows: int, **extra) -> Dict:
    """The stats dict of a streamed fit (the in-memory fit's keys plus
    ``streaming``)."""
    return {"border_sizes": [], "degrees": [], "degree_times": [], "solver_iters": [],
            "regrowths": 0, "m": m, "n": n,
            "streaming": {"chunk_rows": chunk_rows, "num_chunks": 0, "passes": 0}, **extra}


def fit_degrees(source: DataSource, config: OAVIConfig, chunk_rows: int,
                perm: Optional[np.ndarray], device: torch.device, prefetch: bool,
                stats: Dict, *, base=None, capture: bool = False):
    """The degree loop of a streamed fit: per degree, fold the source into
    fresh ``(Lcap, Kcap)`` / ``(Kcap, Kcap)`` accumulators, then run
    :func:`~repro_torch.core.oavi.stats_step` on them.

    ``capture`` (the online fit) folds rows ``[0, aligned)`` first, with
    ``aligned = (m // GRAM_BLOCK) * GRAM_BLOCK``, and snapshots the
    accumulators there before folding the tail.  ``base`` (a
    :class:`repro_torch.online.FitState`, with ``capture``) resumes each
    degree whose record still matches from its snapshot at
    ``base.aligned_rows``, and counts folded and replayed degrees in
    ``stats["online"]``.  Returns ``(book, generators, Lcap, snapshots)``,
    each snapshot the fields of a :class:`repro_torch.online.DegreeRecord`.
    """
    dtype = config.torch_dtype()
    np_dtype = np.dtype(config.dtype)
    m, n = source.num_rows, source.num_features
    aligned = (m // kernel_ops.GRAM_BLOCK) * kernel_ops.GRAM_BLOCK
    book = terms_mod.TermBook(n=n)
    generators: List[Generator] = []
    Lcap = pow2_bucket(config.cap_terms)
    # normalized Gram convention: AtA[0, 0] = ||1||^2 / m = 1
    state = ihb_mod.init_state(Lcap, 1.0, dtype, factors=config.ihb_factors(), device=device)
    ell = 1
    snapshots: List[Dict] = []

    d = 0
    while True:
        d += 1
        if d > config.max_degree:
            stats["termination"] = f"max_degree={config.max_degree}"
            break
        border = book.border(d)
        if not border:
            stats["termination"] = "empty_border"
            break
        K = len(border)
        stats["border_sizes"].append(K)
        stats["degrees"].append(d)

        # capacity: only the O(Lcap^2) state grows; there is no (m, Lcap) A
        while ell + K > Lcap:
            Lcap *= 2
            stats["regrowths"] += 1
            state = ihb_mod.grow_state(state, Lcap)

        Kcap = max(config.cap_border, pow2_bucket(K))
        parents, vars_, _ = border_index_arrays(book, border, Kcap)
        t0 = time.perf_counter()
        acc_fn = ChunkAccumulator(book, Lcap, chunk_rows, device)
        p_t = torch.as_tensor(parents, device=device)
        v_t = torch.as_tensor(vars_, device=device)

        def fold(acc, lo, hi):
            ql, c, chunks = accumulate_source_range(
                acc_fn, source, lo, hi, chunk_rows, acc, p_t, v_t, perm=perm,
                np_dtype=np_dtype, prefetch=prefetch)
            stats["streaming"]["num_chunks"] += chunks
            return ql, c

        rec = base.record_matches(d, book, K, Lcap, Kcap) if base is not None else None
        if rec is not None:
            # resume where the snapshot ends: a GRAM_BLOCK boundary
            acc = (_device.tensor(rec.accQL, dtype, device),
                   _device.tensor(rec.accC, dtype, device))
            start = base.aligned_rows
            stats["online"]["folded_degrees"] += 1
        else:
            acc = (torch.zeros((Lcap, Kcap), dtype=dtype, device=device),
                   torch.zeros((Kcap, Kcap), dtype=dtype, device=device))
            start = 0
            if "online" in stats:
                stats["online"]["replayed_degrees"].append(d)
        if capture:
            acc = fold(acc, start, aligned)
            snapshots.append(dict(degree=d, ell=ell, K=K, Lcap=Lcap, Kcap=Kcap,
                                  accQL=acc[0].cpu().numpy().copy(),
                                  accC=acc[1].cpu().numpy().copy()))
            acc = fold(acc, aligned, m)
        else:
            acc = fold(acc, 0, m)
        stats["streaming"]["passes"] += 1

        res, state = stats_step(config, acc[0], acc[1], state, ell, K, m)
        stats["degree_times"].append(time.perf_counter() - t0)
        stats["solver_iters"].append(int(res.iters.sum()))
        ell = collect_degree(book, border, res.accepted, res.mses, res.coeffs, generators)
    return book, generators, Lcap, snapshots


def fit(
    source,
    config: OAVIConfig = OAVIConfig(),
    *,
    chunk_rows: int = DEFAULT_CHUNK_ROWS,
    prefetch: bool = True,
    device=None,
    mesh=None,
) -> OAVIModel:
    """Run OAVI over a chunked :class:`~repro_torch.streaming.source.
    DataSource` (or an array) without ever holding the evaluation matrix.

    The same model as :func:`repro_torch.core.oavi.fit` on the same rows,
    bit for bit at matched capacity, for any power-of-two ``chunk_rows`` that
    is a multiple of :data:`repro_torch.kernels.ops.GRAM_BLOCK`, with
    ``prefetch`` on or off.  ``source`` must yield data in ``[0, 1]^n``
    (compose with :class:`~repro_torch.streaming.source.ScaledSource`).
    ``device=None`` means the CUDA card; the chunks are staged on the host
    and copied there.  ``mesh`` (the sharded streaming fit) is not ported.
    """
    if mesh is not None:
        raise NotImplementedError(_SHARDED)
    check_config(config)
    source = as_source(source)
    chunk_rows = _check_chunk_rows(chunk_rows)
    dev = _device.resolve(device)
    t_start = time.perf_counter()
    launches0 = kernel_ops.launch_counts()
    reads0 = oracles.host_reads
    m, n = source.num_rows, source.num_features
    stats = new_stats(m, n, chunk_rows)
    perm = None
    if config.ordering in ("pearson", "reverse_pearson"):
        perm = streaming_pearson_order(
            source, chunk_rows, reverse=(config.ordering == "reverse_pearson"))
    book, generators, Lcap, _ = fit_degrees(source, config, chunk_rows, perm, dev,
                                            prefetch, stats)
    finish_fit_stats(stats, book, generators, Lcap, launches0, reads0, t_start)
    return OAVIModel(n=n, psi=config.psi, book=book, generators=generators,
                     feature_perm=perm, stats=stats, dtype=config.dtype, device=dev)


# ---------------------------------------------------------------------------
# Class-batched streaming fit: k out-of-core folds, ONE statistics step
# ---------------------------------------------------------------------------


def fit_classes(
    sources: Sequence,
    config: OAVIConfig = OAVIConfig(),
    *,
    chunk_rows: int = DEFAULT_CHUNK_ROWS,
    prefetch: bool = True,
    device=None,
) -> List[OAVIModel]:
    """Fit one OAVI model per class out-of-core, every class's decisions of
    a degree in ONE :func:`~repro_torch.core.oavi.stats_step_batched`.

    There is no shared row bucket and no row padding: each class streams its
    own rows through its own one-class :class:`ChunkAccumulator` (one Gram
    launch per chunk on the card), and only the statistics step, which does
    not depend on m, runs for the group: one ``ihb_degree`` launch per
    degree for ``fast``, the eager loop with a class axis otherwise.
    Finished classes ride along with all-False valid masks and zeroed
    accumulators (a bitwise no-op); oracle and WIHB configs run the
    fixed-schedule solvers with the in-memory batch's budget escalation
    (the degree's step re-runs from the same statistics and a copy of N).

    Each model equals its class's :func:`fit` bit for bit at matched
    capacity (the shared ``Lcap`` growth).  ``device=None`` means the CUDA
    card.
    """
    from ..core import class_batch as class_batch_mod

    sources = [as_source(s) for s in sources]
    chunk_rows = _check_chunk_rows(chunk_rows)
    if not class_batchable(config):
        raise ValueError(
            "config is not class-batchable (inverse_engine='chol' stays "
            "sequential, as in the reference); use sequential fits"
        )
    check_config(config)
    if not sources:
        return []
    if len(sources) == 1:
        # a lone class rides with a discarded duplicate, as in the reference
        return fit_classes([sources[0], sources[0]], config, chunk_rows=chunk_rows,
                           prefetch=prefetch, device=device)[:1]
    k = len(sources)
    n = sources[0].num_features
    if any(s.num_features != n for s in sources):
        raise ValueError("all classes must share one feature count n")
    ms = [int(s.num_rows) for s in sources]
    dev = _device.resolve(device)
    dtype = config.torch_dtype()
    np_dtype = np.dtype(config.dtype)
    t_start = time.perf_counter()
    launches0 = kernel_ops.launch_counts()
    reads0 = oracles.host_reads
    group = next(class_batch_mod._GROUP_IDS)

    perms: List[Optional[np.ndarray]] = [
        streaming_pearson_order(s, chunk_rows, reverse=(config.ordering == "reverse_pearson"))
        if config.ordering in ("pearson", "reverse_pearson") else None
        for s in sources
    ]
    books = [terms_mod.TermBook(n=n) for _ in range(k)]
    generators: List[List[Generator]] = [[] for _ in range(k)]
    ells = [1] * k
    active = [True] * k
    per_class = [new_stats(ms[c], n, chunk_rows) for c in range(k)]
    degree_times: List[float] = []
    regrowths = 0
    Lcap = pow2_bucket(config.cap_terms)
    state = ihb_mod.init_state(Lcap, 1.0, dtype, factors=config.ihb_factors(), device=dev,
                               classes=k)
    schedule = (oracles.schedule_budget(config.solver)
                if class_batch_mod.needs_solver_schedule(config) else None)
    escalations = 0

    d = 0
    while any(active):
        d += 1
        if d > config.max_degree:
            for c in range(k):
                if active[c]:
                    per_class[c]["termination"] = f"max_degree={config.max_degree}"
            break
        borders: List[List] = []
        for c in range(k):
            b = books[c].border(d) if active[c] else []
            if active[c] and not b:
                active[c] = False
                per_class[c]["termination"] = "empty_border"
            borders.append(b)
        if not any(active):
            break
        Ks = [len(b) for b in borders]
        for c in range(k):
            if borders[c]:
                per_class[c]["border_sizes"].append(Ks[c])
                per_class[c]["degrees"].append(d)

        while max(ells[c] + Ks[c] for c in range(k)) > Lcap:
            Lcap *= 2
            regrowths += 1
            state = ihb_mod.grow_state(state, Lcap)
        Kcap = max(config.cap_border, pow2_bucket(max(Ks)))
        valid = np.zeros((k, Kcap), bool)  # a finished class: all False
        t0 = time.perf_counter()
        # each class folds its own rows: the statistics of its own fit
        QLs, Cs = [], []
        for c in range(k):
            acc = (torch.zeros((Lcap, Kcap), dtype=dtype, device=dev),
                   torch.zeros((Kcap, Kcap), dtype=dtype, device=dev))
            if borders[c]:
                parents_c, vars_c, valid[c] = border_index_arrays(books[c], borders[c], Kcap)
                ql, cc, chunks = accumulate_source_range(
                    ChunkAccumulator(books[c], Lcap, chunk_rows, dev), sources[c], 0, ms[c],
                    chunk_rows, acc, torch.as_tensor(parents_c, device=dev),
                    torch.as_tensor(vars_c, device=dev), perm=perms[c], np_dtype=np_dtype,
                    prefetch=prefetch)
                acc = (ql, cc)
                per_class[c]["streaming"]["num_chunks"] += chunks
                per_class[c]["streaming"]["passes"] += 1
            QLs.append(acc[0])
            Cs.append(acc[1])
        QL_b = torch.stack(QLs)
        C_b = torch.stack(Cs)
        res, state, schedule, escalated = class_batch_mod.escalating_step(
            config, QL_b, C_b, state, ells, Ks, ms, torch.as_tensor(valid, device=dev), schedule)
        escalations += escalated
        degree_times.append(time.perf_counter() - t0)

        for c in range(k):
            if not borders[c]:
                continue
            per_class[c]["solver_iters"].append(int(res.iters[c, : Ks[c]].sum()))
            ells[c] = collect_degree(books[c], borders[c], res.accepted[c], res.mses[c],
                                     res.coeffs[c], generators[c])

    models: List[OAVIModel] = []
    for c in range(k):
        stats = per_class[c]
        # shared by the group: one degree loop, one capacity schedule, one
        # set of launches and host reads serve all k classes
        finish_fit_stats(stats, books[c], generators[c], Lcap, launches0, reads0, t_start)
        stats["degree_times"] = list(degree_times)
        stats["regrowths"] = regrowths
        stats["solver_schedule_len"] = schedule
        stats["solver_escalations"] = escalations
        stats["class_batch"] = {"group": group, "size": k, "index": c,
                                "m_cap": None,  # no shared row bucket, no padding
                                "streaming": True, "regrowths": regrowths}
        models.append(OAVIModel(n=n, psi=config.psi, book=books[c], generators=generators[c],
                                feature_perm=perms[c], stats=stats, dtype=config.dtype,
                                device=dev))
    return models
