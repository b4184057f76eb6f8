"""Convex optimization oracles for OAVI (Line 7 / (CCOP)).

Counterpart of ``src/repro/core/oracles.py``.  All solvers minimize the
quadratic

    f(y) = (y^T Q y + 2 q^T y + btb) / m,      Q = A^T A,  q = A^T b,

either unconstrained (AGD) or over the l1-ball of radius ``r = tau - 1``
(CG / PCG / BPCG), as in Sections 3.3 and 4.3 of the paper.  Working in Gram
form makes an iteration O(l^2), independent of m.  Everything is padded to
``L`` columns with a boolean mask.

Early termination follows Section 6.1: accuracy ``eps = eps_frac * psi``
(the FW gap for the CG variants, the gradient norm for AGD); stop once a
vanishing vector is found (``f <= psi``) or none can exist (``f - gap >
psi``); a hard iteration cap.

Each solver is one ``cond``/``body``/``finish`` triple built by its
``_*_parts`` helper, run by one of two runners:

* :func:`_run_while` — the reference's data-dependent ``while_loop``.  In
  eager PyTorch a host read of ``cond`` costs a device sync, so the body runs
  in chunks of :data:`WHILE_CHUNK` masked steps and the host reads ``cond``
  once per chunk, stopping at the first chunk boundary where it is false.  A
  masked step after ``cond`` turned false keeps every state field as it is
  (``torch.where``), so the result has the bits of one-at-a-time iteration
  and ``iters`` counts the steps actually taken.
* :func:`_run_scheduled` — a fixed budget of masked steps with no host read
  at all; ``converged`` says whether ``cond`` was false at the end.  Chunks of
  steps compose exactly, so a scheduled solve escalated to convergence equals
  the while runner bit for bit.

Vector reductions use :func:`vdot` (elementwise product + sum), the
reduction the reference uses.  Indices chosen on the device (``argmax``)
stay there: values are read with ``gather`` and written with
``scatter_add`` / ``scatter``, never through a host integer.

A class axis (the class-batched fit): every argument may carry a leading
axis of k classes (``Q (k, L, L)``, ``q``/``mask``/``y0 (k, L)``, ``btb
(k,)``), and ``lanes (k,)`` bool says which classes solve; the others keep
their entry state (a class that is done or has no candidate here is a
bitwise no-op).  Elementwise steps, ``argmax``, gathers and scatters run on
all classes at once; each reduction (:func:`vdot`, :func:`mv`) runs class by
class, so every class gets the bits of its own one-class solve whatever k
is.  The scheduled runner then also reads, once per :data:`WHILE_CHUNK`
steps, whether any class still runs, and stops there when none does.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

NEG_INF = float("-inf")
# masked steps of the while runner between two host reads of its condition
WHILE_CHUNK = 16
# host reads of a stopping test (each waits for the device); fits report
# their share in stats["host_reads"]
host_reads = 0


def next_pow2(x: int) -> int:
    """Smallest power of two >= max(x, 1) (schedule buckets)."""
    return 1 << max(int(x) - 1, 0).bit_length()


@dataclasses.dataclass(frozen=True)
class OracleConfig:
    name: str = "bpcg"  # 'agd' | 'cg' | 'pcg' | 'bpcg'
    tau: float = 1000.0  # l1 radius is tau - 1 (CCOP); ignored by AGD
    max_iter: int = 10_000
    eps_frac: float = 0.01  # solver accuracy = eps_frac * psi
    # AGD: power iterations that estimate the smoothness constant
    power_iters: int = 30
    # fixed-schedule runner: initial budget (pow2-bucketed by
    # schedule_budget); 0 checks the certificates at the start only
    schedule: int = 0


def schedule_budget(cfg: OracleConfig) -> int:
    """Initial fixed-schedule iteration budget, from the config alone
    (pow2-bucketed; 0 means a certificate check only)."""
    s = max(int(cfg.schedule), 0)
    return min(next_pow2(int(cfg.max_iter)), next_pow2(s) if s else 0)


def max_schedule(cfg: OracleConfig) -> int:
    """Budget at which every solve has ``converged`` (the ``k < max_iter``
    clause ends it)."""
    return next_pow2(int(cfg.max_iter))


def escalate_schedule(cfg: OracleConfig, schedule: int) -> int:
    return min(max_schedule(cfg), max(int(schedule) * 2, 1))


class SolveResult(NamedTuple):
    y: torch.Tensor  # (L,) solution (zeros outside the mask)
    f: torch.Tensor  # objective value (MSE of the candidate polynomial)
    gap: torch.Tensor  # FW gap (CG variants) or squared gradient norm (AGD)
    iters: torch.Tensor  # iterations taken (int32)
    # True when the stopping predicate held at exit; always True from the
    # while runner, False from the scheduled one when the budget cut it short
    converged: torch.Tensor


def sum_last(x):
    """Sum over the last axis.  With a leading class axis each class's row
    is summed by its own call: a reduction over a batched tensor need not
    give each row the bits of the row alone (on the card its launch shape
    depends on the number of rows)."""
    if x.dim() == 1:
        return torch.sum(x)
    return torch.stack([torch.sum(x[c]) for c in range(x.shape[0])])


def vdot(a, b):
    """Vector dot as elementwise product + sum, the reference's reduction
    (one per class with a class axis)."""
    return sum_last(a * b)


def mv(Q, y):
    """``Q @ y``; with a class axis (``Q (k, L, L)``, ``y (k, L)``) each
    class's product is its own ``mv``, for the reason of :func:`_sum`."""
    if y.dim() == 1:
        return Q @ y
    return torch.stack([Q[c] @ y[c] for c in range(y.shape[0])])


def _lane(x):
    """A per-class scalar (shape ``(k,)``, or ``()`` alone) against per-class
    vectors (``(k, L)``)."""
    return x.unsqueeze(-1)


def quad_f(Q, q, btb, inv_m, y):
    return (vdot(y, mv(Q, y)) + 2.0 * vdot(q, y) + btb) * inv_m


def quad_grad(Q, q, inv_m, y):
    return 2.0 * inv_m * (mv(Q, y) + q)


def _line_search_quad(Q, inv_m, grad, d, gamma_max):
    """Exact line search for the quadratic along ``d``, clipped to
    ``[0, gamma_max]``: f(y + g d) - f(y) = g <grad, d> + g^2 d^T Q d / m."""
    dQd = vdot(d, mv(Q, d)) * inv_m
    num = -vdot(grad, d)
    gamma = torch.where(dQd > 0, num / torch.clamp(2.0 * dQd, min=1e-30), gamma_max)
    return torch.minimum(torch.clamp(gamma, min=0.0), gamma_max)


def _at(v, i):
    """``v[i]`` for a device index ``i`` (one per class), without a host read."""
    return v.gather(-1, i.unsqueeze(-1)).squeeze(-1)


def _add_at(v, i, x):
    """``v.at[i].add(x)`` out of place, for a device index ``i``."""
    return v.scatter_add(-1, i.unsqueeze(-1), x.unsqueeze(-1))


def _scalar(x, dtype, device):
    """``x`` (a number or a one-element tensor) as a 0-d tensor on
    ``device``; a number is filled in place there, since copying it from the
    host would wait for the card."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=dtype).reshape(())
    return torch.full((), x, dtype=dtype, device=device)


def _inv_m(m, dtype, device):
    return 1.0 / _scalar(m, dtype, device)


# --------------------------------------------------------------------------
# Shared runners: one body, two trip-count disciplines
# --------------------------------------------------------------------------


def _select(active, new, old):
    def pick(n, o):
        return torch.where(active.reshape(active.shape + (1,) * (o.dim() - active.dim())), n, o)

    return type(old)(*(pick(n, o) for n, o in zip(new, old)))


def _running(cond, state, lanes):
    c = cond(state)
    return c if lanes is None else c & lanes


def _any(c) -> bool:
    global host_reads
    host_reads += 1
    return bool(c.any() if c.dim() else c)


def _run_while(state0, cond, body, finish, chunk: int = WHILE_CHUNK,
               lanes=None) -> SolveResult:
    """The while runner; with a class axis it runs until no class's ``cond``
    holds, and ``lanes`` (bool per class) keeps the others' state as it is."""
    state = state0
    while _any(_running(cond, state, lanes)):  # one host read per chunk
        for _ in range(chunk):
            state = _select(_running(cond, state, lanes), body(state), state)
    return finish(state)


def _run_scheduled(state0, cond, body, finish, schedule: int,
                   lanes=None) -> SolveResult:
    """At most ``schedule`` masked steps; ``converged`` says, per class,
    whether ``cond`` was false at the end (a class outside ``lanes`` counts as
    converged and keeps its state).  With a class axis the steps run in
    chunks of :data:`WHILE_CHUNK` and stop at the first chunk boundary where
    no class runs: the steps left would be masked no-ops, so the result is
    the full budget's bit for bit."""
    state = state0
    batched = state0.k.dim() > 0
    for s in range(int(schedule)):
        if batched and s % WHILE_CHUNK == 0 and not _any(_running(cond, state, lanes)):
            break
        state = _select(_running(cond, state, lanes), body(state), state)
    return finish(state)._replace(
        converged=torch.logical_not(_running(cond, state, lanes)))


# --------------------------------------------------------------------------
# AGD (Nesterov) — unconstrained
# --------------------------------------------------------------------------


def _estimate_lmax(Q, mask, iters: int):
    """Power iteration on the masked Gram matrix."""
    v = torch.where(mask, 1.0, 0.0).to(Q.dtype)
    v = v / _lane(torch.clamp(torch.sqrt(vdot(v, v)), min=1e-30))
    for _ in range(iters):
        w = mv(Q, v)
        nrm = torch.sqrt(vdot(w, w))
        v = torch.where(_lane(nrm > 0), w / _lane(torch.clamp(nrm, min=1e-30)), v)
    return torch.clamp(vdot(v, mv(Q, v)), min=1e-30)


class _AGDState(NamedTuple):
    y: torch.Tensor
    z: torch.Tensor
    t: torch.Tensor
    k: torch.Tensor
    gnorm2: torch.Tensor


def _agd_parts(Q, q, btb, m, mask, psi, cfg: OracleConfig, y0):
    dtype, dev = Q.dtype, Q.device
    lead = tuple(q.shape[:-1])
    inv_m = _inv_m(m, dtype, dev)
    maskf = mask.to(dtype)
    if y0 is None:
        y0 = torch.zeros(q.shape, dtype=dtype, device=dev)
    y0 = y0 * maskf
    lmax = _estimate_lmax(Q, mask, cfg.power_iters)
    step = 1.0 / (2.0 * lmax * inv_m)  # 1/L_smooth with L = 2 lmax / m
    eps = cfg.eps_frac * psi

    def cond(s: _AGDState):
        return (s.k < cfg.max_iter) & (s.gnorm2 > eps * eps)

    def body(s: _AGDState) -> _AGDState:
        g = quad_grad(Q, q, inv_m, s.z) * maskf
        y_new = s.z - _lane(step) * g
        t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * s.t * s.t))
        z_new = y_new + _lane((s.t - 1.0) / t_new) * (y_new - s.y)
        return _AGDState(y_new, z_new * maskf, t_new, s.k + 1, vdot(g, g))

    def finish(s: _AGDState) -> SolveResult:
        f = quad_f(Q, q, btb, inv_m, s.y)
        return SolveResult(s.y, f, s.gnorm2, s.k,
                           torch.ones(lead, dtype=torch.bool, device=dev))

    g0 = quad_grad(Q, q, inv_m, y0) * maskf
    state0 = _AGDState(y0, y0, torch.ones(lead, dtype=dtype, device=dev),
                       torch.zeros(lead, dtype=torch.int32, device=dev), vdot(g0, g0))
    return state0, cond, body, finish


# --------------------------------------------------------------------------
# Frank-Wolfe variants on the l1-ball of radius r = tau - 1
# --------------------------------------------------------------------------


def _fw_vertex(grad, mask, r):
    """Global LMO over the l1 ball: vertex -r*sign(grad_i*) e_{i*}.  Ties go
    to the first index, as ``jnp.argmax``; sign 0 counts as +1."""
    score = torch.where(mask, torch.abs(grad), NEG_INF)
    i = torch.argmax(score, dim=-1)
    s = -torch.sign(_at(grad, i))
    s = torch.where(s == 0, 1.0, s)
    return i, s * r  # index, signed coordinate value


def _weights_to_point(wp, wm, r):
    return r * (wp - wm)


def _decompose_point(y, r, mask):
    """Represent y (||y||_1 <= r) as convex weights on the vertices +/- r e_i;
    the leftover mass is split evenly between +r e_0 and -r e_0."""
    maskf = mask.to(y.dtype)
    wp = torch.clamp(y, min=0.0) / r * maskf
    wm = torch.clamp(-y, min=0.0) / r * maskf
    leftover = torch.clamp(1.0 - sum_last(wp + wm), min=0.0)
    wp[..., 0] += 0.5 * leftover
    wm[..., 0] += 0.5 * leftover
    return wp, wm


class _FWState(NamedTuple):
    y: torch.Tensor
    wp: torch.Tensor  # weights on +r e_i
    wm: torch.Tensor  # weights on -r e_i
    f: torch.Tensor
    gap: torch.Tensor
    k: torch.Tensor


def _fw_cond(cfg: OracleConfig, psi, s: _FWState):
    eps = cfg.eps_frac * psi
    not_converged = s.gap > eps
    not_vanishing = s.f > psi  # generator already found -> stop
    feasible_possible = (s.f - s.gap) <= psi  # lower bound on f*
    return (s.k < cfg.max_iter) & not_converged & not_vanishing & feasible_possible


def _fw_state0(Q, q, btb, inv_m, y0, wp0, wm0, mask, r):
    """Entry state carrying the true FW gap at ``y0`` (one gradient and one
    LMO), so the Section 6.1 certificates can fire before any step."""
    maskf = mask.to(Q.dtype)
    Qy = mv(Q, y0)  # shared between f0 and the gradient
    f0 = (vdot(y0, Qy) + 2.0 * vdot(q, y0) + btb) * inv_m
    grad = (2.0 * inv_m) * (Qy + q) * maskf
    i, val = _fw_vertex(grad, mask, r)
    # <grad, w - y0> with w = val * e_i, without materializing w
    gap0 = vdot(grad, y0) - _at(grad, i) * val
    return _FWState(y0, wp0, wm0, f0, gap0,
                    torch.zeros(q.shape[:-1], dtype=torch.int32, device=Q.device))


def _fw_finish(s: _FWState) -> SolveResult:
    return SolveResult(s.y, s.f, s.gap, s.k,
                       torch.ones(s.k.shape, dtype=torch.bool, device=s.y.device))


def _fw_setup(Q, q, m, mask, cfg: OracleConfig, y0):
    dtype, dev = Q.dtype, Q.device
    inv_m = _inv_m(m, dtype, dev)
    r = _scalar(cfg.tau - 1.0, dtype, dev)
    maskf = mask.to(dtype)
    if y0 is None:
        y0 = torch.zeros(q.shape, dtype=dtype, device=dev)
    return inv_m, r, maskf, y0 * maskf


def _signed_unit(i, sign_plus, r, zero):
    return zero.scatter(-1, i.unsqueeze(-1), torch.where(sign_plus, r, -r).unsqueeze(-1))


def _cg_parts(Q, q, btb, m, mask, psi, cfg: OracleConfig, y0):
    """Vanilla Frank-Wolfe (CG) with exact line search."""
    inv_m, r, maskf, y0 = _fw_setup(Q, q, m, mask, cfg, y0)
    one = _scalar(1.0, Q.dtype, Q.device)
    zero = torch.zeros_like(y0)

    def body(s: _FWState) -> _FWState:
        y = s.y
        grad = quad_grad(Q, q, inv_m, y) * maskf
        i, val = _fw_vertex(grad, mask, r)
        w = zero.scatter(-1, i.unsqueeze(-1), val.unsqueeze(-1))
        d = w - y
        gap = -vdot(grad, d)
        gamma = _line_search_quad(Q, inv_m, grad, d, one)
        y_new = y + _lane(gamma) * d
        f = quad_f(Q, q, btb, inv_m, y_new)
        return _FWState(y_new, s.wp, s.wm, f, gap, s.k + 1)

    state0 = _fw_state0(Q, q, btb, inv_m, y0, zero, zero, mask, r)
    return state0, (lambda s: _fw_cond(cfg, psi, s)), body, _fw_finish


def _active_extrema(grad, wp, wm, r):
    """Away vertex (argmax <grad, v>) and local FW vertex (argmin) over the
    active set.  Vertex +r e_i has score r*grad_i, -r e_i has -r*grad_i."""
    sp = r * grad
    sm = -r * grad
    away_p = torch.where(wp > 0, sp, NEG_INF)
    away_m = torch.where(wm > 0, sm, NEG_INF)
    ia_p, ia_m = torch.argmax(away_p, dim=-1), torch.argmax(away_m, dim=-1)
    away_is_p = _at(away_p, ia_p) >= _at(away_m, ia_m)
    loc_p = torch.where(wp > 0, sp, -NEG_INF)
    loc_m = torch.where(wm > 0, sm, -NEG_INF)
    il_p, il_m = torch.argmin(loc_p, dim=-1), torch.argmin(loc_m, dim=-1)
    local_is_p = _at(loc_p, il_p) <= _at(loc_m, il_m)
    return (away_is_p, ia_p, ia_m), (local_is_p, il_p, il_m)


def _pcg_parts(Q, q, btb, m, mask, psi, cfg: OracleConfig, y0):
    """Pairwise Conditional Gradients (Lacoste-Julien & Jaggi 2015)."""
    inv_m, r, maskf, y0 = _fw_setup(Q, q, m, mask, cfg, y0)
    zero = torch.zeros_like(y0)
    wp0, wm0 = _decompose_point(y0, r, mask)

    def body(s: _FWState) -> _FWState:
        y, wp, wm = s.y, s.wp, s.wm
        grad = quad_grad(Q, q, inv_m, y) * maskf
        # global FW vertex
        iw, val = _fw_vertex(grad, mask, r)
        w_plus = val > 0
        w_vec = _signed_unit(iw, w_plus, r, zero)
        # away vertex over the active set
        (a_is_p, ia_p, ia_m), _ = _active_extrema(grad, wp, wm, r)
        ia = torch.where(a_is_p, ia_p, ia_m)
        a_vec = _signed_unit(ia, a_is_p, r, zero)
        a_weight = torch.where(a_is_p, _at(wp, ia), _at(wm, ia))
        d = w_vec - a_vec
        gap = -vdot(grad, w_vec - y)  # FW gap for stopping
        gamma = _line_search_quad(Q, inv_m, grad, d, a_weight)
        # move weight gamma from the away vertex to the FW vertex
        a_p, w_p = _lane(a_is_p), _lane(w_plus)
        wp = torch.where(a_p, _add_at(wp, ia, -gamma), wp)
        wm = torch.where(a_p, wm, _add_at(wm, ia, -gamma))
        wp = torch.where(w_p, _add_at(wp, iw, gamma), wp)
        wm = torch.where(w_p, wm, _add_at(wm, iw, gamma))
        wp = torch.clamp(wp, min=0.0)
        wm = torch.clamp(wm, min=0.0)
        y_new = _weights_to_point(wp, wm, r)
        f = quad_f(Q, q, btb, inv_m, y_new)
        return _FWState(y_new, wp, wm, f, gap, s.k + 1)

    state0 = _fw_state0(Q, q, btb, inv_m, y0, wp0, wm0, mask, r)
    return state0, (lambda s: _fw_cond(cfg, psi, s)), body, _fw_finish


def _bpcg_parts(Q, q, btb, m, mask, psi, cfg: OracleConfig, y0):
    """Blended Pairwise Conditional Gradients (Tsuji et al. 2021, Alg. 3).

    The local/global branch is select-based (both computed, one kept), as in
    the reference."""
    inv_m, r, maskf, y0 = _fw_setup(Q, q, m, mask, cfg, y0)
    one = _scalar(1.0, Q.dtype, Q.device)
    zero = torch.zeros_like(y0)
    wp0, wm0 = _decompose_point(y0, r, mask)

    def body(s: _FWState) -> _FWState:
        y, wp, wm = s.y, s.wp, s.wm
        grad = quad_grad(Q, q, inv_m, y) * maskf
        iw, val = _fw_vertex(grad, mask, r)
        w_plus = val > 0
        w_vec = _signed_unit(iw, w_plus, r, zero)
        (a_is_p, ia_p, ia_m), (s_is_p, is_p, is_m) = _active_extrema(grad, wp, wm, r)
        ia = torch.where(a_is_p, ia_p, ia_m)
        a_vec = _signed_unit(ia, a_is_p, r, zero)
        a_weight = torch.where(a_is_p, _at(wp, ia), _at(wm, ia))
        is_ = torch.where(s_is_p, is_p, is_m)
        s_vec = _signed_unit(is_, s_is_p, r, zero)
        gap = -vdot(grad, w_vec - y)
        # Line 7: local pairwise step iff <grad, w - y> >= <grad, s - a>
        local = vdot(grad, w_vec - y) >= vdot(grad, s_vec - a_vec)
        a_p, s_p, w_p = _lane(a_is_p), _lane(s_is_p), _lane(w_plus)

        # local pairwise step
        d_l = s_vec - a_vec
        gamma_l = _line_search_quad(Q, inv_m, grad, d_l, a_weight)
        wp_l = torch.where(a_p, _add_at(wp, ia, -gamma_l), wp)
        wm_l = torch.where(a_p, wm, _add_at(wm, ia, -gamma_l))
        wp_l = torch.where(s_p, _add_at(wp_l, is_, gamma_l), wp_l)
        wm_l = torch.where(s_p, wm_l, _add_at(wm_l, is_, gamma_l))
        y_l = y + _lane(gamma_l) * d_l

        # global FW step
        d_g = w_vec - y
        gamma_g = _line_search_quad(Q, inv_m, grad, d_g, one)
        wp_g = wp * _lane(1.0 - gamma_g)
        wm_g = wm * _lane(1.0 - gamma_g)
        wp_g = torch.where(w_p, _add_at(wp_g, iw, gamma_g), wp_g)
        wm_g = torch.where(w_p, wm_g, _add_at(wm_g, iw, gamma_g))
        y_g = y + _lane(gamma_g) * d_g

        loc = _lane(local)
        y_new = torch.where(loc, y_l, y_g)
        wp_new = torch.clamp(torch.where(loc, wp_l, wp_g), min=0.0)
        wm_new = torch.clamp(torch.where(loc, wm_l, wm_g), min=0.0)
        f = quad_f(Q, q, btb, inv_m, y_new)
        return _FWState(y_new, wp_new, wm_new, f, gap, s.k + 1)

    state0 = _fw_state0(Q, q, btb, inv_m, y0, wp0, wm0, mask, r)
    return state0, (lambda s: _fw_cond(cfg, psi, s)), body, _fw_finish


_PARTS = {
    "agd": _agd_parts,
    "cg": _cg_parts,
    "pcg": _pcg_parts,
    "bpcg": _bpcg_parts,
}


def _make_solvers(name: str):
    def solve_one(Q, q, btb, m, mask, psi, cfg: OracleConfig, y0=None,
                  lanes=None) -> SolveResult:
        return _run_while(*_PARTS[name](Q, q, btb, m, mask, psi, cfg, y0), lanes=lanes)

    def solve_scheduled_one(Q, q, btb, m, mask, psi, cfg: OracleConfig, y0=None,
                            schedule: Optional[int] = None, lanes=None) -> SolveResult:
        if schedule is None:
            schedule = schedule_budget(cfg)
        return _run_scheduled(*_PARTS[name](Q, q, btb, m, mask, psi, cfg, y0), schedule,
                              lanes=lanes)

    solve_one.__name__ = f"solve_{name}"
    solve_scheduled_one.__name__ = f"solve_{name}_scheduled"
    return solve_one, solve_scheduled_one


solve_agd, solve_agd_scheduled = _make_solvers("agd")
solve_cg, solve_cg_scheduled = _make_solvers("cg")
solve_pcg, solve_pcg_scheduled = _make_solvers("pcg")
solve_bpcg, solve_bpcg_scheduled = _make_solvers("bpcg")

SOLVERS = {"agd": solve_agd, "cg": solve_cg, "pcg": solve_pcg, "bpcg": solve_bpcg}

SCHEDULED_SOLVERS = {
    "agd": solve_agd_scheduled,
    "cg": solve_cg_scheduled,
    "pcg": solve_pcg_scheduled,
    "bpcg": solve_bpcg_scheduled,
}


def solve(Q, q, btb, m, mask, psi, cfg: OracleConfig, y0=None, lanes=None) -> SolveResult:
    """The configured solver, run by the while runner.  ``Q`` (L, L), ``q``
    (L,), ``btb`` and ``psi`` tensors on one device, ``mask`` (L,) bool; or
    each with a leading class axis (``Q (k, L, L)``, ``btb (k,)``), and then
    ``lanes (k,)`` bool says which classes solve at all."""
    return SOLVERS[cfg.name](Q, q, btb, m, mask, psi, cfg, y0, lanes=lanes)


def solve_scheduled(Q, q, btb, m, mask, psi, cfg: OracleConfig, y0=None,
                    schedule: Optional[int] = None, lanes=None) -> SolveResult:
    return SCHEDULED_SOLVERS[cfg.name](Q, q, btb, m, mask, psi, cfg, y0,
                                       schedule=schedule, lanes=lanes)
