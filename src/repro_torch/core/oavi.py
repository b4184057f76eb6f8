"""OAVI — the Oracle Approximate Vanishing Ideal algorithm (Algorithm 1).

Counterpart of ``src/repro/core/oavi.py``: both engines (``'fast'``, the
closed-form IHB decisions, and ``'oracle'``, the paper's convex-oracle
variants), both ``inverse_engine`` choices, IHB warm starts and WIHB.

Host-side Python owns the *combinatorics* (term book, DegLex borders, Theorem
4.3); PyTorch owns the linear algebra.  Per degree ``d`` the whole border is
processed by one degree step:

1.  Gram blocks ``QL = A^T B`` (L x K) and ``C = B^T B`` (K x K) of the
    candidate columns ``B = A[:, parents] * X[:, vars]``: the only O(m) work,
    done by :func:`repro_torch.kernels.ops.gram_accumulate` (the hand-written
    CUDA kernel on the card, the plain blocked version on the CPU), reduced
    in the canonical ``GRAM_BLOCK``-row order.
2.  A loop over the K candidates replays the sequential semantics of
    Algorithm 1 from the Gram blocks alone: the ``A^T b`` vector of candidate
    ``a`` is ``QL[:, a]`` plus ``C[j, a]`` scattered into the slots of the
    candidates ``j < a`` appended this degree, and a rejected candidate is
    appended by the Theorem 4.9 update.  On the fast engine with
    ``inverse_engine='inverse'`` the whole loop is
    :func:`repro_torch.kernels.ops.ihb_degree`: one launch of the CUDA kernel
    per degree on the card, the plain eager loop on the CPU, and one host
    sync per degree.  Every other configuration runs the eager loop of
    :func:`_candidate_loop` (closed form, convex oracle of
    :mod:`repro_torch.core.oracles`, (INF) guard, WIHB re-solve, and the
    append through :func:`repro_torch.core.ihb.append_column`, which launches
    the single in-place ``ihb_update`` kernel when ``N`` is kept).
3.  The appended candidate columns are written into ``A``.

``|O|`` capacity (``Lcap``) and border capacity (``Kcap``) are power-of-two
buckets that grow on demand, as in the reference.  ``A`` and ``X`` are kept
with ``m`` padded to a multiple of ``GRAM_BLOCK`` by zero rows, so the Gram
op never copies them to pad.

Every fit loop of the port (this one, the class-batched, streamed and online
fits) is instrumented by :class:`FitScope`, the reference's timing contract
and spans (``fit``, ``fit/degree``, ``fit/regrowth``) with the port's
counterparts of its device fields (:mod:`repro_torch.obs.device`).
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import _device, obs
from ..kernels import ops as kernel_ops
from . import ihb as ihb_mod
from . import oracles
from . import terms as terms_mod
from .ordering import pearson_order


@dataclasses.dataclass(frozen=True)
class OAVIConfig:
    """The reference's ``OAVIConfig`` less its Gram-kernel dispatch knob
    (``kernel``) and Schur guard (``tol_dependent``), which the port does
    not use: ``kernels.ops`` dispatches on the tensors' device."""

    psi: float = 0.005
    engine: str = "fast"  # 'fast' | 'oracle'
    solver: oracles.OracleConfig = dataclasses.field(default_factory=oracles.OracleConfig)
    ihb: bool = True  # warm-start the oracle with the closed-form optimum
    wihb: bool = False  # re-solve accepted generators sparsely (BPCGAVI-WIHB)
    inverse_engine: str = "inverse"  # 'inverse' (Thm 4.9) | 'chol' (beyond-paper)
    max_degree: int = 10
    cap_terms: int = 64  # initial |O| capacity bucket; grows on demand
    cap_border: int = 64  # initial border capacity; grows on demand
    dtype: str = "float32"
    ordering: str = "pearson"  # 'pearson' | 'none' | 'reverse_pearson'

    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def ihb_factors(self) -> Tuple[str, ...]:
        return ihb_mod.factors_for(self.engine, self.inverse_engine, self.ihb,
                                   self.wihb)


class Generator(NamedTuple):
    term: terms_mod.Term  # leading term
    parent_idx: int  # index (into O) of the parent term, term = parent * x_var
    var: int
    coeffs: np.ndarray  # coefficients over O terms (length = |O| at accept time)
    mse: float


@dataclasses.dataclass
class OAVIModel:
    """Output of OAVI: term book for O, generators G, and transform machinery.

    ``device`` is where :meth:`evaluate_O` / :meth:`evaluate_G` run.
    """

    n: int
    psi: float
    book: terms_mod.TermBook
    generators: List[Generator]
    feature_perm: Optional[np.ndarray]  # Pearson ordering permutation (or None)
    stats: Dict
    dtype: str = "float32"
    device: torch.device = dataclasses.field(default_factory=lambda: torch.device("cpu"))

    @property
    def num_O(self) -> int:
        return len(self.book)

    @property
    def num_G(self) -> int:
        return len(self.generators)

    def term_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        return (
            np.asarray(self.book.parents, dtype=np.int32),
            np.asarray(self.book.vars, dtype=np.int32),
        )

    def generator_arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        k = len(self.generators)
        ell = len(self.book)
        C = np.zeros((ell, k), dtype=np.dtype(self.dtype))
        gp = np.zeros((k,), dtype=np.int32)
        gv = np.zeros((k,), dtype=np.int32)
        for j, g in enumerate(self.generators):
            C[: len(g.coeffs), j] = g.coeffs
            gp[j] = g.parent_idx
            gv[j] = g.var
        return C, gp, gv

    def _as_input(self, Z) -> torch.Tensor:
        return _device.tensor(Z, getattr(torch, self.dtype), self.device)

    def evaluate_O(self, Z) -> torch.Tensor:
        """Evaluation matrix O(Z): (q, |O|) — degree-wavefront evaluation."""
        parents, vars_ = self.term_arrays()
        return evaluate_terms(self._as_input(Z), parents, vars_)

    def evaluate_G(self, Z) -> torch.Tensor:
        """Evaluation matrix G(Z): (q, |G|).  Theorem 4.2 machinery."""
        Z = self._as_input(Z)
        if self.feature_perm is not None:
            Z = Z[:, torch.as_tensor(self.feature_perm, device=self.device)]
        cols = self.evaluate_O(Z)
        if not self.generators:
            return Z.new_zeros((Z.shape[0], 0))
        C, gp, gv = self.generator_arrays()
        dev = self.device
        lead = cols[:, torch.as_tensor(gp, device=dev).long()] * Z[
            :, torch.as_tensor(gv, device=dev).long()
        ]
        return cols @ torch.as_tensor(C, device=dev) + lead

    def mse(self, Z) -> torch.Tensor:
        """Per-generator MSE over Z."""
        G = self.evaluate_G(Z)
        return torch.mean(G * G, dim=0)

    def transform(self, Z) -> np.ndarray:
        """(FT) for this model alone: ``|G(Z)|`` as (q, |G|) in model dtype."""
        return np.abs(self.evaluate_G(Z).cpu().numpy())

    def to_state_dict(self) -> Tuple[Dict[str, np.ndarray], Dict]:
        """Flat array tree + JSON-safe metadata, in the JAX package's layout
        (the term book and leading terms replay from the ``(parent, var)``
        chains)."""
        parents, vars_ = self.term_arrays()
        k = len(self.generators)
        L = len(self.book)
        coeffs = np.zeros((k, L), dtype=np.dtype(self.dtype))
        lens = np.zeros((k,), np.int32)
        gp = np.zeros((k,), np.int32)
        gv = np.zeros((k,), np.int32)
        mses = np.zeros((k,), np.float64)
        for j, g in enumerate(self.generators):
            coeffs[j, : len(g.coeffs)] = g.coeffs
            lens[j] = len(g.coeffs)
            gp[j] = g.parent_idx
            gv[j] = g.var
            mses[j] = g.mse
        perm = (
            np.asarray(self.feature_perm, np.int32)
            if self.feature_perm is not None
            else np.zeros((0,), np.int32)
        )
        arrays = {
            "book_parents": parents,
            "book_vars": vars_,
            "gen_coeffs": coeffs,
            "gen_lens": lens,
            "gen_parent": gp,
            "gen_var": gv,
            "gen_mse": mses,
            "feature_perm": perm,
        }
        meta = {
            "kind": "oavi",
            "n": int(self.n),
            "psi": float(self.psi),
            "dtype": str(self.dtype),
            "has_perm": self.feature_perm is not None,
            "stats": self.stats,
        }
        return arrays, meta

    @classmethod
    def from_state_dict(cls, arrays: Dict[str, np.ndarray], meta: Dict,
                        device=None) -> "OAVIModel":
        """Rebuild a model from :meth:`to_state_dict` output (also the JAX
        package's); ``device=None`` means the CUDA card."""
        n = int(meta["n"])
        dtype = str(meta["dtype"])
        bp = np.asarray(arrays["book_parents"]).astype(np.int64)
        bv = np.asarray(arrays["book_vars"]).astype(np.int64)
        book = terms_mod.TermBook(n=n)
        for i in range(1, bp.shape[0]):
            parent = book.terms[int(bp[i])]
            var = int(bv[i])
            book.append(terms_mod.multiply_by_var(parent, var), parent, var)
        coeffs = np.asarray(arrays["gen_coeffs"]).astype(np.dtype(dtype))
        lens = np.asarray(arrays["gen_lens"]).astype(np.int64)
        gp = np.asarray(arrays["gen_parent"]).astype(np.int64)
        gv = np.asarray(arrays["gen_var"]).astype(np.int64)
        mses = np.asarray(arrays["gen_mse"]).astype(np.float64)
        generators = []
        for j in range(gp.shape[0]):
            p, v = int(gp[j]), int(gv[j])
            generators.append(
                Generator(
                    term=terms_mod.multiply_by_var(book.terms[p], v),
                    parent_idx=p,
                    var=v,
                    coeffs=coeffs[j, : int(lens[j])].copy(),
                    mse=float(mses[j]),
                )
            )
        perm = (
            np.asarray(arrays["feature_perm"]).astype(np.int64)
            if meta.get("has_perm")
            else None
        )
        return cls(
            n=n,
            psi=float(meta["psi"]),
            book=book,
            generators=generators,
            feature_perm=perm,
            stats=dict(meta.get("stats") or {}),
            dtype=dtype,
            device=_device.resolve(device),
        )

    def save(self, path: str) -> str:
        """Persist via :func:`repro_torch.api.save`."""
        from .. import api

        return api.save(self, path)


# ---------------------------------------------------------------------------
# Term evaluation: degree wavefronts
# ---------------------------------------------------------------------------


def wavefront_schedule(parents, vars_):
    """Degree-wavefront evaluation plan for a term book.

    A term's parent has exactly one degree less (``term = parent * x_var``),
    so all terms of one degree evaluate in one batched gather+product over the
    previous degree's block — O(max_degree) sequential steps, not O(|O|).

    Returns ``(waves, perm)``: ``waves[d] = (parent_pos, var)`` with
    ``parent_pos`` indexing into the degree-``d-1`` block, and ``perm`` the
    gather restoring original column order after concatenating the blocks
    (``None`` when the book is already degree-ordered).
    """
    parents = np.asarray(parents, np.int64)
    vars_np = np.asarray(vars_, np.int64)
    L = parents.shape[0]
    deg = np.zeros((L,), np.int64)
    for i in range(1, L):
        deg[i] = deg[parents[i]] + 1
    waves = []
    prev_idx = np.zeros((1,), np.int64)  # wave 0: the constant column
    order = [prev_idx]
    for d in range(1, int(deg.max()) + 1 if L > 1 else 1):
        idx = np.nonzero(deg == d)[0]
        pos = np.searchsorted(prev_idx, parents[idx])
        if not np.array_equal(prev_idx[pos], parents[idx]):
            raise ValueError("term book is not an order ideal: parent not at degree d-1")
        waves.append((pos, vars_np[idx]))
        order.append(idx)
        prev_idx = idx
    order = np.concatenate(order)
    perm = None if np.array_equal(order, np.arange(L)) else np.argsort(order)
    return tuple(waves), perm


def apply_wavefronts(Z: torch.Tensor, waves, perm=None) -> torch.Tensor:
    """Evaluate a wavefront schedule over ``Z``: one column gather + product
    per degree (each reading only the previous degree's block), one concat,
    and — only for fused multi-book plans — one column permutation.

    The JAX package expressed the gathers as one-hot matmuls for the TPU's
    matrix unit; on the GPU they are index gathers, which give the same bits
    (a one-hot product sums one value and exact zeros).
    """
    dev = Z.device
    prev = Z.new_ones((Z.shape[0], 1))
    blocks = [prev]
    for pos, var in waves:
        pos_t = torch.as_tensor(pos, device=dev)
        var_t = torch.as_tensor(var, device=dev)
        prev = prev[:, pos_t] * Z[:, var_t]
        blocks.append(prev)
    cols = torch.cat(blocks, dim=1) if len(blocks) > 1 else blocks[0]
    if perm is not None:
        cols = cols[:, torch.as_tensor(perm, device=dev)]
    return cols


def evaluate_terms(Z: torch.Tensor, parents, vars_) -> torch.Tensor:
    """Evaluate all O terms over Z: ``col_i = col_parent * Z[:, var]``."""
    waves, perm = wavefront_schedule(parents, vars_)
    return apply_wavefronts(Z, waves, perm)


# ---------------------------------------------------------------------------
# The degree step
# ---------------------------------------------------------------------------


class DegreeResult(NamedTuple):
    """Host copies of one degree's decisions (first K candidates)."""

    accepted: np.ndarray  # (K,) bool
    mses: np.ndarray  # (K,)
    coeffs: np.ndarray  # (K, Lcap)
    slots: np.ndarray  # (K,) slot of each appended candidate, Lcap otherwise
    iters: np.ndarray  # (K,) solver iterations (0 for the closed form)


def stats_step(cfg: OAVIConfig, QL_raw, C_raw, state: ihb_mod.IHBState,
               ell0: int, K: int, m_total: int):
    """Every accept/reject decision of one degree from the raw Gram
    statistics alone (the reference's ``_make_stats_degree_step``, its
    ``while_loop`` solvers).  Returns ``(DegreeResult, new IHB state)``.

    The K valid candidates run in order; padded lanes ``K..Kcap`` are never
    visited (the reference masks them to no-ops).  The fast engine with
    ``inverse_engine='inverse'`` and no WIHB runs ``ops.ihb_degree``: one
    launch of the hand-written kernel on the card (the state's ``N`` updated
    in place), its plain eager version on the CPU, one host read per degree.
    Every other configuration runs :func:`_candidate_loop`.
    """
    dtype = cfg.torch_dtype()
    np_dtype = np.dtype(cfg.dtype)
    dev = QL_raw.device
    # normalized Gram convention (Abar = A / sqrt(m)): MSE(g) = btb + q^T y;
    # 1/m is rounded in the working dtype, as the reference does
    inv_m = torch.tensor(np_dtype.type(1.0) / np_dtype.type(m_total), dtype=dtype,
                         device=dev)
    QL = (QL_raw * inv_m).to(dtype)
    C = (C_raw * inv_m).to(dtype)
    if cfg.engine == "fast" and cfg.inverse_engine != "chol" and not cfg.wihb:
        out = kernel_ops.ihb_degree(QL.T.contiguous(), C, state.N, ell0, cfg.psi, K)
        iters = np.zeros((K,), np.int32)
    else:
        *out, iters, state, _ = _candidate_loop(cfg, QL, C, state, ell0, K)
        iters = iters.cpu().numpy()
    accepted, mses, coeffs, slots = (t.cpu().numpy() for t in out[:4])
    kernel_ops.count_flops(kernel_ops.ihb_degree_flops(accepted[:K], ell0))
    return DegreeResult(accepted=accepted, mses=mses, coeffs=coeffs, slots=slots,
                        iters=iters), state


def _candidate_loop(cfg: OAVIConfig, QL, C, state: ihb_mod.IHBState,
                    ell0, K: int, *, valid=None, schedule: Optional[int] = None):
    """The candidate loop of :func:`stats_step` in eager ops, the reference's
    ``body`` candidate by candidate:

    * the closed form ``y0`` from ``N`` (or, on the Cholesky engine, two
      triangular solves on ``R``) wherever the engine needs it;
    * ``engine='fast'``: the verdict from ``y0`` itself;
    * ``engine='oracle'``: the configured solver on ``AtA`` (the Gram is
      normalized, so ``m = 1``), warm-started from ``y0`` with IHB while the
      (INF) guard allows (paper section 4.4.3: once a warm start leaves the
      l1 ball, IHB stays off for the rest of the degree), cold otherwise;
    * WIHB: an accepted candidate is re-solved by a cold BPCG and keeps the
      sparse solution where that one vanishes too;
    * a rejected candidate is appended (:func:`ihb.append_column`, gated on
      the device).

    The solvers read their stopping test on the host (once per
    :data:`oracles.WHILE_CHUNK`-step chunk), and WIHB reads the verdict, so
    the oracle engine syncs at least once per candidate; the fast engine's
    loop never syncs.  Returns ``(accepted, mses, coeffs, slots, iters,
    state, unconverged)``.

    With a class axis (the class-batched fit) ``QL (k, Lcap, Kcap)``, ``C``,
    the state and ``ell0 (k,)`` carry k classes, ``valid (k, Kcap)`` marks
    each class's real candidates and ``K`` is the most any class has.  Every
    class runs exactly the operations it runs alone (elementwise ones on all
    classes at once, reductions class by class; see
    :mod:`repro_torch.core.oracles`), an invalid candidate is a bitwise no-op
    for its class, the (INF) guard trips only on valid ones (the reference's
    ``ihb_live & (feasible | ~valid[a])``), and the WIHB re-solve is
    select-based.  ``schedule`` runs the solvers on that fixed budget
    (:func:`oracles._run_scheduled`); ``unconverged (k,)`` then says which
    classes had a valid solve cut short by it.
    """
    dtype = cfg.torch_dtype()
    dev = QL.device
    lead = tuple(QL.shape[:-2])
    Lcap, Kcap = QL.shape[-2:]
    engine_oracle = cfg.engine == "oracle"
    need_closed_form = (not engine_oracle) or cfg.ihb
    use_chol = cfg.inverse_engine == "chol"
    if schedule is None:
        solver = oracles.SOLVERS[cfg.solver.name]
        wihb_solver = oracles.solve_bpcg
    else:
        solver = functools.partial(oracles.SCHEDULED_SOLVERS[cfg.solver.name],
                                   schedule=schedule)
        wihb_solver = functools.partial(oracles.solve_bpcg_scheduled, schedule=schedule)
    psi = torch.tensor(cfg.psi, dtype=dtype, device=dev)
    one = torch.ones((), dtype=dtype, device=dev)  # m: the Gram is normalized
    radius = cfg.solver.tau - 1.0
    # one trash row at index Lcap absorbs the scatter of candidates that were
    # not appended, so the scatter below needs no host-side mask
    QLx = torch.cat([QL, QL.new_zeros(lead + (1, Kcap))], dim=-2)
    ar = torch.arange(Lcap, device=dev)
    ell = torch.as_tensor(ell0, dtype=torch.int32, device=dev).reshape(lead)
    ihb_live = torch.ones(lead, dtype=torch.bool, device=dev)
    slots = torch.full(lead + (K,), Lcap, dtype=torch.long, device=dev)
    accepted = torch.zeros(lead + (K,), dtype=torch.bool, device=dev)
    coeffs = torch.zeros(lead + (K, Lcap), dtype=dtype, device=dev)
    mses = torch.zeros(lead + (K,), dtype=dtype, device=dev)
    iters = torch.zeros(lead + (K,), dtype=torch.int32, device=dev)
    unconverged = torch.zeros(lead, dtype=torch.bool, device=dev)
    no_slot = torch.tensor(Lcap, dtype=torch.long, device=dev)
    no_iters = torch.zeros(lead, dtype=torch.int32, device=dev)

    for a in range(K):
        q = QLx[..., a].clone()
        if a > 0:
            # correction for the columns appended earlier in this degree; the
            # slots are distinct, so the scatter is deterministic
            before = slots[..., :a]
            q.scatter_(-1, before, q.gather(-1, before) + C[..., :a, a])
        q = q[..., :Lcap]
        btb = C[..., a, a]
        mask = ar < ell.unsqueeze(-1)
        live = None if valid is None else valid[..., a]
        if need_closed_form:
            if use_chol:
                y0 = ihb_mod.closed_form_cholesky(state, q)
            else:
                y0 = ihb_mod.closed_form_inverse(state, q)
            y0 = torch.where(mask, y0, 0.0)
        if not engine_oracle:
            # sum(q * y0), the reduction the reference uses
            y, mse, it = y0, btb + oracles.vdot(q, y0), no_iters
        else:
            if cfg.ihb:
                # (INF) guard; only valid candidates may trip it
                feasible = oracles.sum_last(torch.abs(y0)) <= radius
                warm = torch.where((ihb_live & feasible).unsqueeze(-1), y0, 0.0)
                ihb_live = ihb_live & (feasible if live is None else feasible | ~live)
            else:
                warm = None
            res = solver(state.AtA, q, btb, one, mask, psi, cfg.solver, warm, lanes=live)
            y, mse, it = res.y, res.f, res.iters
            if schedule is not None:
                unconverged = unconverged | (live & ~res.converged)
        accept = mse <= psi if live is None else (mse <= psi) & live
        if cfg.wihb:
            # re-solve an accepted generator sparsely from a cold start
            if live is None:
                oracles.host_reads += 1
                run = bool(accept)
            else:
                run = True  # select-based: every class, solving where accepted
            if run:
                res = wihb_solver(state.AtA, q, btb, one, mask, psi, cfg.solver, None,
                                  lanes=None if live is None else accept)
                take = res.f <= psi if live is None else accept & (res.f <= psi)
                y = torch.where(take.unsqueeze(-1), res.y, y)
                mse = torch.where(take, res.f, mse)
                it = it + (res.iters if live is None else torch.where(accept, res.iters, 0))
                if schedule is not None:
                    unconverged = unconverged | (accept & ~res.converged)
        # on reject: append the column to O (slot = ell) and update the factors
        do_append = ~accept if live is None else ~accept & live
        state = ihb_mod.append_column(state, q, btb, ell, active=do_append)
        slots[..., a] = torch.where(do_append, ell.long(), no_slot)
        ell = ell + do_append.to(torch.int32)
        accepted[..., a] = accept
        coeffs[..., a, :] = torch.where(accept.unsqueeze(-1), y, 0.0)
        mses[..., a] = mse
        iters[..., a] = it
    return accepted, mses, coeffs, slots, iters, state, unconverged


def degree_step(cfg: OAVIConfig, A, X, state, ell0: int, parents, vars_, K: int,
                m_total: int, reduce=None):
    """One degree in memory: the fused Gram op, the candidate loop
    (:func:`stats_step`), and the appended columns written into ``A``.

    ``A`` is updated in place (the JAX package donates it to the same end).
    ``reduce`` (the data-parallel fit, :mod:`repro_torch.core.distributed`)
    maps the raw local ``(QL, C)`` to their sum over every row shard; the
    candidate loop then runs on the reduced blocks.  Returns
    ``(DegreeResult, new IHB state)``.
    """
    dev = A.device
    p_t = torch.as_tensor(parents, device=dev)
    v_t = torch.as_tensor(vars_, device=dev)
    # all O(m) work: the hand-written kernel on the card
    QL_raw, C_raw = kernel_ops.gram_accumulate(A, X, p_t, v_t)
    if reduce is not None:
        QL_raw, C_raw = reduce(QL_raw, C_raw)
    res, state = stats_step(cfg, QL_raw, C_raw, state, ell0, K, m_total)
    Lcap = A.shape[1]
    idx = np.nonzero((~res.accepted) & (res.slots < Lcap))[0]
    if idx.size:
        sel = torch.as_tensor(idx, device=dev)
        cols = A[:, p_t[sel]] * X[:, v_t[sel]]
        A.index_copy_(1, torch.as_tensor(res.slots[idx], device=dev), cols)
    return res, state


class BatchedDegreeResult(NamedTuple):
    """Host copies of one class-batched degree's decisions: :class:`
    DegreeResult`'s fields with a leading class axis (``(k, Kmax)``,
    ``(k, Kmax, Lcap)``), and the classes whose fixed-schedule solve was cut
    short (all False off the scheduled path)."""

    accepted: np.ndarray
    mses: np.ndarray
    coeffs: np.ndarray
    slots: np.ndarray
    iters: np.ndarray
    unconverged: np.ndarray  # (k,) bool


def stats_step_batched(cfg: OAVIConfig, QL_raw, C_raw, state: ihb_mod.IHBState,
                       ells, Ks, m_totals, valid, schedule: Optional[int] = None):
    """:func:`stats_step` for k classes at once (the reference's vmapped
    ``_make_stats_degree_step``): ``QL_raw (k, Lcap, Kcap)``, ``C_raw (k,
    Kcap, Kcap)`` and the state carry a class axis; class ``c`` starts from
    ``ells[c]`` columns, has ``Ks[c]`` candidates (0 when it is done) and
    ``m_totals[c]`` rows, and ``valid (k, Kcap)`` marks its candidates on
    the device.

    The fast engine without WIHB runs ``ops.ihb_degree_batched`` (one launch
    for every class on the card, the per-class plain loop on the CPU); every
    other configuration runs :func:`_candidate_loop` with the class axis,
    its solvers on the fixed ``schedule`` where one is given.  Each class
    gets the bits of its own :func:`stats_step`.  ``N`` is updated in place;
    a caller that may re-run the degree (schedule escalation) passes a copy.
    Returns ``(BatchedDegreeResult, new IHB state)``.
    """
    dtype = cfg.torch_dtype()
    np_dtype = np.dtype(cfg.dtype)
    dev = QL_raw.device
    k = QL_raw.shape[0]
    # 1/m rounded in the working dtype per class, as the one-class step does
    inv_m = torch.tensor(np.asarray([np_dtype.type(1.0) / np_dtype.type(m) for m in m_totals],
                                    np_dtype), dtype=dtype, device=dev)[:, None, None]
    QL = (QL_raw * inv_m).to(dtype)
    C = (C_raw * inv_m).to(dtype)
    Kmax = max(int(x) for x in Ks)
    if cfg.engine == "fast" and not cfg.wihb:
        out = kernel_ops.ihb_degree_batched(QL.transpose(-1, -2).contiguous(), C, state.N,
                                            ells, cfg.psi, Ks)
        iters = np.zeros((k, Kmax), np.int32)
        unconverged = np.zeros((k,), bool)
    else:
        ell0 = torch.tensor([int(e) for e in ells], dtype=torch.int32, device=dev)
        *out, iters, state, unconverged = _candidate_loop(
            cfg, QL, C, state, ell0, Kmax, valid=valid, schedule=schedule)
        iters, unconverged = iters.cpu().numpy(), unconverged.cpu().numpy()
    accepted, mses, coeffs, slots = (t.cpu().numpy() for t in out[:4])
    kernel_ops.count_flops(sum(kernel_ops.ihb_degree_flops(accepted[c, : int(Ks[c])], int(ells[c]))
                               for c in range(k)))
    return BatchedDegreeResult(accepted=accepted, mses=mses, coeffs=coeffs, slots=slots,
                               iters=iters, unconverged=unconverged), state


def class_batchable(config: OAVIConfig) -> bool:
    """Whether a config may take the class-batched fit
    (:mod:`repro_torch.core.class_batch`), as in the reference: every engine
    with the Theorem 4.9 inverse (``fast``, ``fast`` with WIHB, and the
    convex oracles on their fixed-schedule solvers).  The Cholesky engine is
    not: the reference's batched triangular solves are not bit-stable, and
    the port keeps its rule."""
    return config.inverse_engine == "inverse"


def pow2_bucket(x: int) -> int:
    """Smallest power of two >= x (shape bucketing for Lcap / Kcap)."""
    return 1 << max(int(x) - 1, 1).bit_length() if x > 2 else 2


def border_index_arrays(book: terms_mod.TermBook, border, Kcap: int):
    """Padded (parents, vars, valid) host arrays for one degree's border."""
    parents = np.zeros((Kcap,), np.int64)
    vars_ = np.zeros((Kcap,), np.int64)
    valid = np.zeros((Kcap,), bool)
    for i, (term, parent, j) in enumerate(border):
        parents[i] = book.index[parent]
        vars_[i] = j
        valid[i] = True
    return parents, vars_, valid


def collect_degree(book, border, accepted, mses, coeffs, generators) -> int:
    """Host-side bookkeeping after a degree step: accepted candidates become
    generators, rejected ones extend the term book.  Returns the new |O|."""
    for i, (term, parent, j) in enumerate(border):
        if accepted[i]:
            ell_at = len(book)
            generators.append(
                Generator(
                    term=term,
                    parent_idx=book.index[parent],
                    var=j,
                    coeffs=coeffs[i, :ell_at].copy(),
                    mse=float(mses[i]),
                )
            )
        else:
            book.append(term, parent, j)
    return len(book)


def sample_memory_stats(stats: Dict, device=None) -> None:
    """Record the card's memory high-water marks into a fit ``stats`` dict
    (``peak_bytes``, ``live_bytes_peak``; nothing off the card) through
    :func:`repro_torch.obs.device.sample_memory`, which also refreshes the
    ``device.*`` gauges and the trace's memory timeline.  ``peak_bytes`` is
    the allocator's high-water mark since the process started or its last
    reset: compare it with ``peak_bytes_start``."""
    obs.device.sample_memory(stats, device)


def init_fit_stats(m: int, n: int, device=None, **extra) -> Dict:
    """The ``stats`` skeleton shared by the local, class-batched, streamed
    and online fit loops (the reference's keys; its ``recompiles`` counts
    jit traces, which the eager port has none of)."""
    stats = {
        "border_sizes": [],
        "solver_iters": [],
        "degrees": [],
        "degree_times": [],
        "regrowths": 0,
        # fixed-schedule solver discipline (batched oracle/WIHB fits only)
        "solver_schedule_len": None,
        "solver_escalations": 0,
        # analytic work per degree (kernels.ops.flop_count; None while device
        # capture is off), kernel-build seconds inside this fit, and the work
        # over the degree time
        "flops_per_degree": [],
        "compile_seconds": 0.0,
        "achieved_gflops": None,
        "time_total": 0.0,
        "m": m,
        "n": n,
    }
    peak = obs.device.device_memory_stats(device).get("peak_bytes_in_use")
    if peak is not None:
        stats["peak_bytes_start"] = int(peak)
    stats.update(extra)
    return stats


class _DegreeScope:
    """One degree step's timing window (see :meth:`FitScope.degree`)."""

    __slots__ = ("_scope", "_span", "_t0", "_flops0")

    def __init__(self, scope: "FitScope", span) -> None:
        self._scope = scope
        self._span = span

    def __enter__(self) -> "_DegreeScope":
        self._span.__enter__()
        self._flops0 = kernel_ops.flop_count()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        t1 = time.perf_counter()
        self._span.__exit__(exc_type, exc, tb)
        scope = self._scope
        dur = t1 - self._t0
        if scope._t_first_degree is None:
            scope._t_first_degree = self._t0
        scope._t_last_degree_end = t1
        scope._time_degrees += dur
        scope.stats["degree_times"].append(round(dur, 6))
        flops = kernel_ops.flop_count() - self._flops0
        scope.record_flops(flops if obs.device.device_enabled() else None)
        sample_memory_stats(scope.stats, scope.device)


class FitScope:
    """Instrumentation shared by every fit loop (local, class-batched,
    streamed, online): the reference's ``FitScope``.

    Owns the *timing contract* of fit ``stats``::

        time_total == time_setup + time_degrees + time_finalize
                      + time_unattributed          # exact, by construction

    * ``time_total``    wall time from scope entry to :meth:`finalize`.
    * ``time_setup``    entry -> first degree step (feature ordering, the
      initial buffers; the streamed fit's Pearson moment pass).
    * ``time_degrees``  unrounded sum of the per-degree segments, each from
      the degree's first launch to the host copy of its decisions (so it
      includes a kernel build at the first launch); ``sum(stats[
      "degree_times"])`` equals it up to their 6-decimal rounding.
    * ``time_finalize`` last degree's end -> :meth:`finalize`.
    * ``time_unattributed`` the residual: host combinatorics between the
      degrees (borders, regrowth, collecting decisions).

    Each degree also records its analytic work as dispatched
    (``flops_per_degree``, from :func:`repro_torch.kernels.ops.flop_count`:
    the Gram at its padded capacity shapes, the candidate loop on its real
    decisions), and :meth:`finalize` adds ``compile_seconds`` (kernel builds
    inside the fit), ``achieved_gflops`` (that work over ``time_degrees``,
    a rate of the dispatched work), the kernel launches and host reads since
    the scope began, and the ``fit.seconds`` histogram.  Timing is always
    on; the spans reach the trace only while :func:`repro_torch.obs.enabled`,
    and nothing here changes what the fit computes.
    """

    def __init__(self, stats: Dict, backend: str = "local", name: str = "fit",
                 device=None) -> None:
        self.stats = stats
        self.backend = backend
        self.device = device
        attrs = {k: stats[k] for k in ("m", "n") if stats.get(k) is not None}
        self._span = obs.span(name, backend=backend, **attrs)
        self._t_start = time.perf_counter()
        self._t_first_degree: Optional[float] = None
        self._t_last_degree_end: Optional[float] = None
        self._time_degrees = 0.0
        self._timing: Optional[Dict] = None
        self._flops = 0.0
        self._compile0 = obs.device.compile_snapshot()
        self._launches0 = kernel_ops.launch_counts()
        self._reads0 = oracles.host_reads
        self._profile = None

    def __enter__(self) -> "FitScope":
        self._span.__enter__()
        # OBS_TORCH_PROFILE=<dir>: the whole fit in one torch.profiler capture
        self._profile = obs.device.profile_window(f"fit/{self.backend}")
        self._profile.__enter__()
        self._t_start = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self._profile.__exit__(exc_type, exc, tb)
        self._span.__exit__(exc_type, exc, tb)

    def degree(self, d: int, **attrs) -> _DegreeScope:
        """Context manager timing one degree step: on exit it appends the
        rounded segment to ``stats["degree_times"]`` and the degree's work to
        ``stats["flops_per_degree"]``, and samples memory."""
        return _DegreeScope(self, obs.span("fit/degree", d=d, backend=self.backend, **attrs))

    def regrowth(self, Lcap: int) -> None:
        self.stats["regrowths"] += 1
        obs.registry().counter("fit.regrowths", backend=self.backend).inc()
        obs.event("fit/regrowth", backend=self.backend, Lcap=int(Lcap))

    def record_flops(self, flops: Optional[float]) -> None:
        """Append one degree's work (None = capture off)."""
        self.stats.setdefault("flops_per_degree", []).append(flops)
        if flops:
            self._flops += flops

    def timing_fields(self) -> Dict:
        """The timing-contract fields and the launches and host reads since
        the scope began, computed once (shared by every class of a batched
        fit, so their stats agree to the bit)."""
        if self._timing is None:
            t_end = time.perf_counter()
            total = t_end - self._t_start
            if self._t_first_degree is None:
                setup, degrees, fin = total, 0.0, 0.0
            else:
                setup = self._t_first_degree - self._t_start
                degrees = self._time_degrees
                fin = t_end - self._t_last_degree_end
            launches1 = kernel_ops.launch_counts()
            self._timing = {
                "time_total": total,
                "time_setup": setup,
                "time_degrees": degrees,
                "time_finalize": fin,
                "time_unattributed": total - setup - degrees - fin,
                "kernel_launches": {k: launches1[k] - self._launches0[k] for k in launches1},
                "host_reads": oracles.host_reads - self._reads0,
            }
        return self._timing

    def finalize(self, book, generators, Lcap: int, config: "OAVIConfig",
                 stats: Optional[Dict] = None) -> Dict:
        """Fill the summary and timing fields every fit loop reports."""
        stats = self.stats if stats is None else stats
        sample_memory_stats(stats, self.device)
        timing = self.timing_fields()
        stats.update({k: v for k, v in timing.items() if k != "kernel_launches"})
        stats["kernel_launches"] = dict(timing["kernel_launches"])
        stats["compile_seconds"] = round(obs.device.compile_snapshot()[0] - self._compile0[0], 6)
        if self._flops > 0.0 and timing["time_degrees"] > 0.0:
            stats["achieved_gflops"] = round(self._flops / timing["time_degrees"] / 1e9, 3)
            obs.registry().gauge("device.achieved_gflops", backend=self.backend).set(
                stats["achieved_gflops"])
        stats["num_G"] = len(generators)
        stats["num_O"] = len(book)
        stats["G_plus_O"] = len(generators) + len(book)
        stats["Lcap_final"] = int(Lcap)
        stats["thm43_bound"] = terms_mod.theorem_4_3_size_bound(config.psi, book.n)
        obs.registry().histogram("fit.seconds", backend=self.backend).observe(
            stats["time_total"])
        return stats


def check_config(config: OAVIConfig) -> None:
    """Raise on an engine, solver or ordering the fit does not know."""
    if config.engine not in ("fast", "oracle"):
        raise ValueError(f"unknown engine {config.engine!r}; expected 'fast' or 'oracle'")
    if config.solver.name not in oracles.SOLVERS:
        raise ValueError(f"unknown solver {config.solver.name!r}")
    if config.ordering not in ("pearson", "reverse_pearson", "none"):
        raise ValueError(f"unknown ordering {config.ordering!r}")


def order_features(X: np.ndarray, ordering: str):
    """``(X with its columns in Pearson order, the permutation)``; ``(X,
    None)`` for ``ordering='none'``."""
    if ordering == "none":
        return X, None
    perm = pearson_order(X, reverse=(ordering == "reverse_pearson"))
    return X[:, perm], perm


def fit(X, config: OAVIConfig = OAVIConfig(), *, device=None) -> OAVIModel:
    """Run OAVI on ``X`` (m, n) in [0,1]^n.  ``device=None`` means the CUDA
    card (and raises without one); pass ``device="cpu"`` for the CPU."""
    check_config(config)
    dev = _device.resolve(device)
    X = np.asarray(X)
    m, n = X.shape
    stats = init_fit_stats(m, n, device=dev)

    with FitScope(stats, backend="local", device=dev) as scope:
        X, perm = order_features(X, config.ordering)
        # rows padded once to the Gram block with zeros (bitwise no-ops)
        Xd = torch.zeros((kernel_ops.round_up(m, kernel_ops.GRAM_BLOCK), n),
                         dtype=config.torch_dtype(), device=dev)
        Xd[:m] = _device.tensor(X, config.torch_dtype(), dev)
        book, generators, Lcap = fit_rows(Xd, m, m, config, scope)
        scope.finalize(book, generators, Lcap, config)
    return OAVIModel(
        n=n,
        psi=config.psi,
        book=book,
        generators=generators,
        feature_perm=perm,
        stats=stats,
        dtype=config.dtype,
        device=dev,
    )


def fit_rows(Xd: torch.Tensor, valid: int, m_total: int, config: OAVIConfig,
             scope: FitScope, reduce=None):
    """The in-memory degree loop over the rows ``Xd`` (already ordered, on
    the device, a whole number of Gram blocks), whose first ``valid`` rows
    are real and the rest zeros.  ``m_total`` is the sample count of the
    fit (``valid`` itself for the local fit; every shard's rows together for
    the data-parallel fit, whose ``reduce`` sums the raw Gram blocks over
    the shards).  Returns ``(book, generators, Lcap)``; each degree runs in
    ``scope``'s timing window."""
    stats = scope.stats
    dev, dtype = Xd.device, Xd.dtype
    m_rows, n = Xd.shape
    book = terms_mod.TermBook(n=n)
    generators: List[Generator] = []

    Lcap = pow2_bucket(config.cap_terms)
    A = torch.zeros((m_rows, Lcap), dtype=dtype, device=dev)
    A[:valid, 0] = 1.0  # the constant column is the row mask
    # normalized Gram convention: AtA[0,0] = ||1||^2 / m = 1
    state = ihb_mod.init_state(Lcap, 1.0, dtype, factors=config.ihb_factors(), device=dev)
    ell = 1

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

        # capacity management: regrowth into the next pow2 bucket
        while ell + K > Lcap:
            Lcap *= 2
            scope.regrowth(Lcap)
            grown = torch.zeros((m_rows, Lcap), dtype=dtype, device=dev)
            grown[:, : A.shape[1]] = A
            A = grown
            state = ihb_mod.grow_state(state, Lcap)

        Kcap = max(config.cap_border, pow2_bucket(K))
        parents, vars_, _ = border_index_arrays(book, border, Kcap)
        with scope.degree(d, K=K):
            res, state = degree_step(config, A, Xd, state, ell, parents, vars_, K, m_total,
                                     reduce=reduce)
        stats["solver_iters"].append(int(res.iters.sum()))
        ell = collect_degree(book, border, res.accepted, res.mses, res.coeffs, generators)
    return book, generators, Lcap
