"""Class-batched OAVI: the k per-class fits of Algorithm 2 as one batched fit.

Counterpart of ``src/repro/core/class_batch.py``.  Algorithm 2 fits one
generator model per class; the per-class problems share nothing but the
algorithm, yet a sequential loop pays k dispatch pipelines per degree.  This
module stacks them on a leading class axis and runs each degree once for all
of them:

* **Padded class buckets.**  Each class's rows are padded to a shared
  ``m_cap`` (default ``pow2_bucket(max m_c)``; the rows held on the device
  are that rounded up to the Gram block), with the constant-1 column built
  as the class's *row mask*, so padded rows are zero in every column of A
  and add exact zeros to every Gram entry.  One ``Lcap`` is shared and
  regrows when the largest class overflows; ``Kcap = max(cap_border,
  pow2_bucket(max K_c))``.
* **Batched state.**  ``A`` is ``(k, m, Lcap)``, the IHB factors ``(k, Lcap,
  Lcap)``, the border index arrays ``(k, Kcap)`` with a validity mask.
* **One launch per degree for the group.**  The Gram is
  ``ops.gram_accumulate_batched`` (one launch of the hand-written kernel for
  every class on the card); the fast engine's candidate loop is
  ``ops.ihb_degree_batched`` (one cooperative launch); the other engines run
  the eager candidate loop with a class axis
  (:func:`repro_torch.core.oavi._candidate_loop`), appending through
  ``ops.ihb_update_batched_`` (one launch per candidate for every class).
* **Done masking.**  A class that has finished rides along with an
  all-False mask: its slice of the step is a bitwise no-op.
* **Fixed-schedule solvers.**  Oracle and WIHB configurations run their
  solvers on a shared iteration budget (``oracles.schedule_budget``); when a
  valid class's solve is cut short the budget doubles and the degree's
  candidate loop runs again from the same Gram and a copy of the state (one
  verdict read per degree), up to ``oracles.max_schedule``.  Escalated to
  convergence, the scheduled solves equal the sequential fit's while-runner
  solves bit for bit.

Bit-exactness: every class gets the bits of its own sequential fit at
matched capacity (the same ``Lcap``, ``Kcap`` and row count): the kernels'
lanes are their one-class calls', the plain versions run class by class,
and the eager loop's reductions run class by class (see
:mod:`repro_torch.core.oracles`).  The port's Gram sums 256-row blocks in a
fixed order and a block of zero rows adds exact zeros, so the row padding
changes no bit either (``tests/test_torch_class_batch.py`` holds uneven
class sizes against the unpadded sequential fit).

The host planner (:func:`class_buckets`, :func:`plan_class_groups`) is a copy
of the reference's (stdlib and numpy only).  Class-batched streaming is
:func:`repro_torch.streaming.fit_classes`.  The group's degree loop runs in
one :class:`~repro_torch.core.oavi.FitScope` (backend ``class_batch``), whose
timing fields every class's stats share.  The reference's ``recompiles``
count jit traces, which the eager port has none of.

**Data-parallel composition** (``mesh=``, the reference's vmap inside
``shard_map``): the class axis is replicated and the sample axis split over
the mesh's data axes as in :mod:`repro_torch.core.distributed`.  Each rank
holds every class's contiguous span of the ``(k, m_rows, .)`` blocks
(``m_rows`` the bucket rounded up to ``shards * GRAM_BLOCK``), runs the
batched Gram on its spans, and issues ONE all_reduce of ``(k, Lcap, Kcap) +
(k, Kcap, Kcap)`` a degree; the candidate loop then runs on the reduced
blocks, replicated on every rank.  A world of one is the local batched fit
bit for bit.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import _device
from ..kernels import ops as kernel_ops
from . import distributed as distributed_mod
from . import ihb as ihb_mod
from . import oavi as oavi_mod
from . import oracles
from . import terms as terms_mod
from .oavi import (
    FitScope,
    OAVIConfig,
    OAVIModel,
    border_index_arrays,
    class_batchable,
    init_fit_stats,
    pow2_bucket,
    stats_step_batched,
)

# one id per batched fit: the classifier's aggregation counts each group's
# shared counters once
_GROUP_IDS = itertools.count()


def needs_solver_schedule(config: OAVIConfig) -> bool:
    """Whether batched fits of this config run the fixed-schedule solvers
    (every path that calls a convex oracle)."""
    return config.engine == "oracle" or config.wihb


def _grow_rows(A: torch.Tensor, Lcap: int) -> torch.Tensor:
    grown = A.new_zeros(A.shape[:-1] + (Lcap,))
    grown[..., : A.shape[-1]] = A
    return grown


def fit_classes(
    Xs: Sequence[np.ndarray],
    config: OAVIConfig = OAVIConfig(),
    *,
    m_cap: Optional[int] = None,
    mesh=None,
    data_axes: Sequence[str] = ("data",),
    device=None,
) -> List[OAVIModel]:
    """Fit one OAVI model per class, every degree once for all classes.

    The same models as ``[oavi.fit(X, config) for X in Xs]``, bit for bit at
    matched capacity (see the module docstring).  ``m_cap`` overrides the
    shared row bucket (default ``pow2_bucket(max m_c)``).  ``mesh`` (a
    ``DeviceMesh``) splits the sample axis over its ``data_axes``; every
    rank calls with the same ``Xs`` and gets the same models, whose stats
    then also carry ``mesh``, ``m_padded`` and ``all_reduces``.
    ``device=None`` means the CUDA card.  Every model's stats carry a ``"class_batch"`` dict
    (``group``, ``size``, ``index``, ``m_cap``, ``regrowths``); the group's
    shared counters (``regrowths``, ``kernel_launches``, ``host_reads``,
    ``solver_escalations``) must be counted once per group, not once per
    class: :func:`repro_torch.api.aggregate_fit_stats` does.
    """
    if not class_batchable(config):
        raise ValueError(
            "config is not class-batchable (inverse_engine='chol' stays "
            "sequential, as in the reference); use sequential fits"
        )
    oavi_mod.check_config(config)
    Xs = [np.asarray(X) for X in Xs]
    if not Xs:
        return []
    k = len(Xs)
    n = Xs[0].shape[1]
    if any(X.ndim != 2 or X.shape[1] != n for X in Xs):
        raise ValueError("all classes must be (m_c, n) with one shared n")
    ms = [int(X.shape[0]) for X in Xs]
    dev = _device.resolve(device)
    group = next(_GROUP_IDS)
    # the group's own record: one degree loop, one capacity schedule, one
    # set of launches and host reads serve all k classes
    batch: Dict = {"group": group, "size": k, "m_cap": 0, "regrowths": 0,
                   "degree_times": [], "flops_per_degree": [], "m": int(sum(ms)), "n": n}
    lay = None if mesh is None else distributed_mod.layout(mesh, data_axes)
    scope = FitScope(batch, backend="class_batch", device=dev)
    with scope:
        return _fit_group(Xs, config, m_cap, dev, scope, lay)


def _fit_group(Xs, config: OAVIConfig, m_cap, dev, scope: FitScope,
               lay: Optional[distributed_mod.ShardLayout]) -> List[OAVIModel]:
    """The body of :func:`fit_classes`, inside the group's scope; ``lay``
    is this rank's data shard (``None``: the local fit)."""
    batch = scope.stats
    group, k, n = batch["group"], batch["size"], batch["n"]
    ms = [int(X.shape[0]) for X in Xs]
    dtype = config.torch_dtype()
    # per-class Pearson ordering (each class permutes its own features)
    Xp, perms = zip(*(oavi_mod.order_features(X, config.ordering) for X in Xs))

    mc = max(int(m_cap) if m_cap is not None else pow2_bucket(max(ms)), max(ms))
    batch["m_cap"] = int(mc)
    # rows held on the device: this rank's span of the bucket rounded to
    # shards * GRAM_BLOCK (the local fit, a world of one: the bucket rounded
    # to the Gram block), padded with zeros
    shard = lay or distributed_mod.layout()
    lo, m_rows, _ = shard.rows(mc)
    collective = shard.stats(mc)
    reduce = shard.reducer(collective)
    Xd = torch.zeros((k, m_rows, n), dtype=dtype, device=dev)
    Lcap = pow2_bucket(config.cap_terms)
    A = torch.zeros((k, m_rows, Lcap), dtype=dtype, device=dev)
    for c, X in enumerate(Xp):
        lo_c, hi_c = shard.span(ms[c])
        Xd[c, : hi_c - lo_c] = _device.tensor(X[lo_c:hi_c], dtype, dev)
        A[c, : hi_c - lo_c, 0] = 1.0  # the constant column is the class's row mask
    # normalized Gram convention: AtA[0, 0] = ||mask_c||^2 / m_c = 1 per class
    state = ihb_mod.init_state(Lcap, 1.0, dtype, factors=config.ihb_factors(),
                               device=dev, classes=k)

    books = [terms_mod.TermBook(n=n) for _ in range(k)]
    generators: List[List] = [[] for _ in range(k)]
    ells = [1] * k
    active = [True] * k
    per_class: List[Dict] = [init_fit_stats(ms[c], n, device=dev) for c in range(k)]
    # the shared fixed-schedule budget (oracle / WIHB configs): it starts at
    # the config's bucket, doubles whenever a valid class's solve was cut
    # short, and persists across degrees
    schedule = (oracles.schedule_budget(config.solver)
                if needs_solver_schedule(config) else None)
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

        # shared capacity: regrow when the largest class overflows
        while max(ells[c] + Ks[c] for c in range(k)) > Lcap:
            Lcap *= 2
            scope.regrowth(Lcap)
            A = _grow_rows(A, Lcap)
            state = ihb_mod.grow_state(state, Lcap)

        Kcap = max(config.cap_border, pow2_bucket(max(Ks)))
        parents = np.zeros((k, Kcap), np.int64)
        vars_ = np.zeros((k, Kcap), np.int64)
        valid = np.zeros((k, Kcap), bool)  # a done class: all False, a no-op
        for c in range(k):
            if borders[c]:
                parents[c], vars_[c], valid[c] = border_index_arrays(books[c], borders[c],
                                                                     Kcap)
        with scope.degree(d, K=int(max(Ks)), k=k):
            p_t = torch.as_tensor(parents, device=dev)
            v_t = torch.as_tensor(vars_, device=dev)
            valid_t = torch.as_tensor(valid, device=dev)
            # all O(m) work: one launch of the hand-written kernel for the group
            QL_raw, C_raw = reduce(*kernel_ops.gram_accumulate_batched(A, Xd, p_t, v_t))
            res, state, schedule, escalated = escalating_step(
                config, QL_raw, C_raw, state, ells, Ks, ms, valid_t, schedule)
            escalations += escalated

            # appended candidates' columns into each class's slice of A
            kmax = res.accepted.shape[1]
            in_border = np.arange(kmax)[None, :] < np.asarray(Ks)[:, None]
            ci, ai = np.nonzero(in_border & ~res.accepted & (res.slots < Lcap))
            if ci.size:
                c_t = torch.as_tensor(ci, device=dev)
                a_t = torch.as_tensor(ai, device=dev)
                cols = A[c_t, :, p_t[c_t, a_t]] * Xd[c_t, :, v_t[c_t, a_t]]
                A[c_t, :, torch.as_tensor(res.slots[ci, ai], device=dev)] = cols

        for c in range(k):
            if not borders[c]:
                continue
            per_class[c]["solver_iters"].append(int(res.iters[c, : Ks[c]].sum()))
            ells[c] = oavi_mod.collect_degree(books[c], borders[c], res.accepted[c],
                                              res.mses[c], res.coeffs[c], generators[c])

    models: List[OAVIModel] = []
    for c in range(k):
        stats = per_class[c]
        # shared by the group: one degree loop, one capacity schedule, one
        # set of launches and host reads serve all k classes
        stats["degree_times"] = list(batch["degree_times"])
        stats["flops_per_degree"] = list(batch["flops_per_degree"])
        stats["regrowths"] = batch["regrowths"]
        stats["solver_schedule_len"] = schedule
        stats["solver_escalations"] = escalations
        stats["class_batch"] = {"group": group, "size": k, "index": c, "m_cap": int(mc),
                                "regrowths": batch["regrowths"]}
        if lay is not None:
            stats.update(collective)
        scope.finalize(books[c], generators[c], Lcap, config, stats=stats)
        models.append(OAVIModel(n=n, psi=config.psi, book=books[c], generators=generators[c],
                                feature_perm=perms[c], stats=stats, dtype=config.dtype,
                                device=dev))
    return models


def escalating_step(config: OAVIConfig, QL_raw, C_raw, state: ihb_mod.IHBState, ells, Ks,
                    ms, valid, schedule: Optional[int]):
    """One class-batched degree's decisions (:func:`~repro_torch.core.oavi.
    stats_step_batched`) under the escalation protocol: while a valid
    class's solve was cut short by the fixed-schedule budget, the budget
    doubles and the step runs again from the same Gram and a copy of N (the
    step updates N in place; AtA is not touched before the end), up to
    ``oracles.max_schedule``.  Returns ``(result, new state, schedule,
    escalations)``."""
    escalations = 0
    while True:
        st_in = state
        if schedule is not None and state.N is not None:
            st_in = state._replace(N=state.N.clone())
        res, st_out = stats_step_batched(config, QL_raw, C_raw, st_in, ells, Ks, ms, valid,
                                         schedule)
        if (schedule is None or not bool(res.unconverged.any())
                or schedule >= oracles.max_schedule(config.solver)):
            return res, st_out, schedule, escalations
        schedule = oracles.escalate_schedule(config.solver, schedule)
        escalations += 1


def class_buckets(sizes: Sequence[int]) -> Dict[int, List[int]]:
    """Group class indices into shared row buckets (greedy, largest first):
    every class with ``m >= cap/2`` joins the bucket ``cap =
    pow2_bucket(largest remaining m)``, so per-class row padding stays <= 2x.
    With lognormal-skewed class sizes this keeps a giant class from
    inflating every small class's padded rows."""
    order = sorted(range(len(sizes)), key=lambda i: -sizes[i])
    buckets: Dict[int, List[int]] = {}
    i = 0
    while i < len(order):
        cap = pow2_bucket(sizes[order[i]])
        group = [j for j in order[i:] if 2 * sizes[j] >= cap]
        buckets[cap] = sorted(group)
        i += len(group)
    return buckets


def plan_class_groups(
    sizes: Sequence[int], pad_limit: float = 2.0
) -> List[tuple]:
    """Plan the shared row buckets of a multi-class fit as ``[(m_cap,
    class_indices), ...]`` — :func:`class_buckets` plus two refinements that
    trade padded rows for fewer dispatch groups:

    1. **Cross-bucket merging** (largest cap first): a smaller bucket folds
       into the preceding larger one while the merged group's total padded
       rows stay within ``pad_limit`` of its real rows, so near-boundary
       buckets don't each pay their own dispatch pipeline.
    2. **No stragglers**: any group left with a single class is folded —
       unconditionally — into whichever surviving group grows its padded-row
       bill the least.

    The resulting per-class padding is reported by the API layer in
    ``stats["class_batch_padding"]``.
    """
    if len(sizes) == 0:
        return []
    buckets = class_buckets(sizes)
    groups = [
        [cap, list(idxs)] for cap, idxs in sorted(buckets.items(), reverse=True)
    ]
    merged = [groups[0]]
    for cap, idxs in groups[1:]:
        host = merged[-1]
        count = len(host[1]) + len(idxs)
        real = sum(sizes[i] for i in host[1]) + sum(sizes[i] for i in idxs)
        if host[0] * count <= pad_limit * real:
            host[1] = sorted(host[1] + idxs)
        else:
            merged.append([cap, list(idxs)])
    while len(merged) > 1:
        singles = [g for g in merged if len(g[1]) == 1]
        if not singles:
            break
        g = singles[0]
        merged.remove(g)
        s = sizes[g[1][0]]

        def extra(h):
            new_cap = max(h[0], pow2_bucket(s))
            return new_cap * (len(h[1]) + 1) - h[0] * len(h[1])

        host = min(merged, key=extra)
        host[0] = max(host[0], pow2_bucket(s))
        host[1] = sorted(host[1] + g[1])
    return [(int(cap), idxs) for cap, idxs in merged]
