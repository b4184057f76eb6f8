"""The port's convex oracles (``repro_torch.core.oracles``) on the CPU.

Against the JAX package (``repro.core.oracles``) on the ``_problem``
instances of ``tests/test_oracles.py`` (the same generator, copied here), and
inside the port bit for bit: the chunked while runner against the scheduled
runner, escalation, budget 0, chunk-size invariance.

Tolerances against the reference, and why:

* ``f``: every solve stops with an FW gap (CG variants) below ``eps =
  eps_frac * psi`` or at a vanishing value, so both packages' ``f`` lie in
  ``[f*, f* + eps]``: held to ``eps`` (plus fp32 rounding of ``f`` itself).
* ``y``: ``f(y) - f* = (y - y*)^T Q (y - y*)`` for the unconstrained optimum
  inside the ball, so two solutions within ``eps`` of ``f*`` lie within
  ``2 sqrt(eps / lambda_min(Q))`` of each other: the test computes that bound
  from the instance.
* ``iters``: AGD and CG take the same steps as the reference (equal counts
  on every instance).  PCG and BPCG choose away and local vertices by
  ``argmax``/``argmin`` over scores that tie to ~1e-6 relative on these
  instances (the decomposition of ``y0 = 0`` puts equal weight on ``+r e_0``
  and ``-r e_0``); the two frameworks' fp32 sums round such a near-tie
  either way, after which the runs take different, equally valid paths
  (BPCG, seed 3, step 11: local vertex scores -23.495552 and -23.495532).
  Their counts are held within a factor 2 of the reference's; measured: PCG
  differs on 1 of 6 seeds by 3 steps, BPCG on 6 of 6 by 1-15 steps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import oracles as J
from repro_torch.core import oracles as P

NAMES = ["agd", "cg", "pcg", "bpcg"]


def _problem(seed, m=200, ell=6, Lcap=8):
    rng = np.random.default_rng(seed)
    A = rng.uniform(0, 1, (m, ell)).astype(np.float32)
    b = rng.uniform(0, 1, m).astype(np.float32)
    Q = np.zeros((Lcap, Lcap), np.float32)
    q = np.zeros((Lcap,), np.float32)
    Q[:ell, :ell] = A.T @ A / m
    q[:ell] = A.T @ b / m
    btb = np.float32(b @ b / m)
    mask = np.arange(Lcap) < ell
    y_star = -np.linalg.solve(Q[:ell, :ell] + 1e-9 * np.eye(ell), q[:ell])
    f_star = (y_star @ Q[:ell, :ell] @ y_star + 2 * q[:ell] @ y_star + btb)
    return Q, q, btb, mask, y_star, f_star


def _cfg(name, **kw):
    kw = {"max_iter": 5000, "eps_frac": 1e-3, "tau": 1000.0, **kw}
    return P.OracleConfig(name=name, **kw), J.OracleConfig(name=name, **kw)


def _port_args(seed, **pkw):
    Q, q, btb, mask, *_ = _problem(seed, **pkw)
    return (torch.from_numpy(Q), torch.from_numpy(q), torch.tensor(btb), 1.0,
            torch.from_numpy(mask))


def _psi(x):
    return torch.tensor(x, dtype=torch.float32)


def _warm(y_star, Lcap=8):
    warm = np.zeros(Lcap, np.float32)
    warm[: len(y_star)] = y_star
    return warm


def _assert_same_result(a, b, what=""):
    assert torch.equal(a.y, b.y), f"{what}: y"
    assert torch.equal(a.f, b.f), f"{what}: f"
    assert torch.equal(a.gap, b.gap), f"{what}: gap"
    assert int(a.iters) == int(b.iters), f"{what}: iters"


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("name", NAMES)
def test_solver_matches_reference(name, seed):
    Q, q, btb, mask, *_ = _problem(seed)
    pcfg, jcfg = _cfg(name)
    psi = 0.005
    ref = J.SOLVERS[name](jnp.asarray(Q), jnp.asarray(q), jnp.asarray(btb),
                          jnp.asarray(1.0), jnp.asarray(mask),
                          jnp.asarray(psi, jnp.float32), jcfg, None)
    got = P.solve(*_port_args(seed), _psi(psi), pcfg)
    eps = pcfg.eps_frac * psi
    assert abs(float(got.f) - float(ref.f)) <= eps + 1e-6
    lam_min = np.linalg.eigvalsh(Q[:6, :6].astype(np.float64)).min()
    bound = 2.0 * np.sqrt(eps / lam_min)
    assert np.abs(got.y.numpy() - np.asarray(ref.y)).max() <= bound
    assert bool(got.converged)
    if name in ("agd", "cg"):
        assert int(got.iters) == int(ref.iters)
    else:
        r, p = int(ref.iters), int(got.iters)
        assert r / 2 <= p <= 2 * r, (p, r)


@pytest.mark.parametrize("name", NAMES)
def test_solver_reaches_near_optimum(name):
    *_, f_star = _problem(0)
    res = P.solve(*_port_args(0), _psi(0.005), _cfg(name)[0])
    assert float(res.f) <= max(float(f_star) + 5e-3, 0.005 + 1e-6)


@pytest.mark.parametrize("name", ["cg", "pcg", "bpcg"])
def test_fw_iterates_stay_in_l1_ball(name):
    cfg = P.OracleConfig(name=name, max_iter=300, eps_frac=1e-4, tau=2.0)
    res = P.solve(*_port_args(1), _psi(1e-9), cfg)
    assert float(torch.sum(torch.abs(res.y))) <= cfg.tau - 1.0 + 1e-4


def test_warm_start_reduces_iterations():
    """IHB's premise: starting at the closed-form optimum needs ~no steps."""
    *_, y_star, _ = _problem(2)
    args = _port_args(2)
    cfg = _cfg("cg")[0]
    cold = P.solve(*args, _psi(1e-9), cfg)
    hot = P.solve(*args, _psi(1e-9), cfg, torch.from_numpy(_warm(y_star)))
    assert int(hot.iters) <= int(cold.iters)
    assert int(hot.iters) <= 2


@pytest.mark.parametrize("name", NAMES)
def test_while_runner_equals_scheduled_full_budget(name):
    """The chunked while runner and the scheduled runner at full budget give
    the same bits on every field: one body, masked steps are no-ops."""
    args = _port_args(3)
    cfg = P.OracleConfig(name=name, max_iter=512, eps_frac=1e-3, tau=1000.0)
    ref = P.SOLVERS[name](*args, _psi(1e-6), cfg)
    sch = P.SCHEDULED_SOLVERS[name](*args, _psi(1e-6), cfg,
                                    schedule=P.max_schedule(cfg))
    assert int(ref.iters) > P.WHILE_CHUNK  # several chunks, a ragged last one
    assert bool(sch.converged)
    _assert_same_result(ref, sch, name)


@pytest.mark.parametrize("chunk", [1, 5, 64])
@pytest.mark.parametrize("name", NAMES)
def test_while_runner_chunk_invariant(name, chunk):
    """``iters`` counts the steps taken, not chunk multiples, and the bits do
    not depend on the chunk size (1 = the reference's one-at-a-time loop)."""
    cfg = P.OracleConfig(name=name, max_iter=512, eps_frac=1e-3, tau=10.0)
    parts = P._PARTS[name](*_port_args(4), _psi(1e-6), cfg, None)
    ref = P._run_while(*parts)
    got = P._run_while(*P._PARTS[name](*_port_args(4), _psi(1e-6), cfg, None),
                       chunk=chunk)
    _assert_same_result(ref, got, f"{name} chunk={chunk}")


@pytest.mark.parametrize("name", NAMES)
def test_scheduled_escalation_reaches_while_runner(name):
    args = _port_args(4)
    cfg = P.OracleConfig(name=name, max_iter=512, eps_frac=1e-3, tau=1000.0)
    ref = P.SOLVERS[name](*args, _psi(1e-7), cfg)
    schedule, escalations = 1, 0
    while True:
        sch = P.SCHEDULED_SOLVERS[name](*args, _psi(1e-7), cfg, schedule=schedule)
        if bool(sch.converged) or schedule >= P.max_schedule(cfg):
            break
        schedule = P.escalate_schedule(cfg, schedule)
        escalations += 1
    assert bool(sch.converged)
    assert escalations >= 1, "problem too easy to exercise escalation"
    _assert_same_result(ref, sch, name)


@pytest.mark.parametrize("name", ["cg", "pcg", "bpcg"])
def test_scheduled_budget_zero_warm_certificate(name):
    """Budget 0 checks the certificates only: a warm start at the solution
    fires them with no step, as the while runner (one host read) does."""
    *_, y_star, f_star = _problem(5)
    args = _port_args(5)
    psi = _psi(float(f_star) + 1e-3)  # the warm start vanishes
    cfg = _cfg(name)[0]
    warm = torch.from_numpy(_warm(y_star))
    ref = P.SOLVERS[name](*args, psi, cfg, warm)
    sch = P.SCHEDULED_SOLVERS[name](*args, psi, cfg, warm, schedule=0)
    assert bool(sch.converged) and int(sch.iters) == 0
    _assert_same_result(ref, sch, name)


@pytest.mark.parametrize("seed,ell,name,tau,psi", [
    (0, 2, "agd", 2.0, 1e-7), (11, 7, "cg", 2.0, 1e-3), (42, 4, "pcg", 10.0, 0.05),
    (7, 5, "bpcg", 1000.0, 1e-7), (3, 3, "pcg", 2.0, 1e-7), (9, 6, "bpcg", 2.0, 1e-3),
])
def test_scheduled_matches_while_sweep(seed, ell, name, tau, psi):
    """Problems, masks, radii and accuracy targets (the reference's
    property sweep, as fixed cases): full budget equals the while runner."""
    args = _port_args(seed, m=80, ell=ell, Lcap=8)
    cfg = P.OracleConfig(name=name, max_iter=512, eps_frac=1e-3, tau=tau)
    ref = P.SOLVERS[name](*args, _psi(psi), cfg)
    sch = P.SCHEDULED_SOLVERS[name](*args, _psi(psi), cfg,
                                    schedule=P.max_schedule(cfg))
    assert bool(sch.converged)
    _assert_same_result(ref, sch, f"{name} seed={seed}")


def test_schedule_budget_is_config_only():
    for kw in ({"schedule": 0}, {"schedule": 3}, {"schedule": 64, "max_iter": 16},
               {"schedule": 1000}, {"max_iter": 10_000}):
        assert P.schedule_budget(P.OracleConfig(**kw)) == J.schedule_budget(J.OracleConfig(**kw))
        assert P.max_schedule(P.OracleConfig(**kw)) == J.max_schedule(J.OracleConfig(**kw))
    assert P.schedule_budget(P.OracleConfig(schedule=3)) == 4
    assert P.escalate_schedule(P.OracleConfig(), 0) == 1
    assert P.escalate_schedule(P.OracleConfig(), 4) == 8
    assert P.escalate_schedule(P.OracleConfig(max_iter=16), 16) == 16
    assert dataclasses_fields(P.OracleConfig) == dataclasses_fields(J.OracleConfig)


def dataclasses_fields(cls):
    import dataclasses

    return [(f.name, f.default) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("grad,mask,want_i,want_sign", [
    ([0.5, -0.5, 0.5, 0.1], [1, 1, 1, 1], 0, -1.0),   # three-way tie: first wins
    ([0.1, -0.7, 0.7, 0.0], [1, 1, 1, 1], 1, 1.0),    # tie of opposite signs
    ([0.0, 0.0, 0.0, 0.0], [1, 1, 1, 0], 0, 1.0),     # sign(0) counts as +1
    ([0.9, 0.2, -0.2, 0.0], [0, 1, 1, 1], 1, -1.0),   # masked entry never wins
])
def test_fw_vertex_ties_as_reference(grad, mask, want_i, want_sign):
    g, msk = np.asarray(grad, np.float32), np.asarray(mask, bool)
    ji, jv = J._fw_vertex(jnp.asarray(g), jnp.asarray(msk), 3.0)
    pi, pv = P._fw_vertex(torch.from_numpy(g), torch.from_numpy(msk), 3.0)
    assert int(pi) == int(ji) == want_i
    assert float(pv) == float(jv) == want_sign * 3.0


def test_active_extrema_ties_as_reference():
    g = np.asarray([0.3, -0.3, 0.3, 0.2, -0.2, 0.0], np.float32)
    wp = np.asarray([0.2, 0.0, 0.2, 0.1, 0.0, 0.0], np.float32)
    wm = np.asarray([0.0, 0.3, 0.0, 0.0, 0.2, 0.0], np.float32)
    ref = J._active_extrema(jnp.asarray(g), jnp.asarray(wp), jnp.asarray(wm), 2.0)
    got = P._active_extrema(torch.from_numpy(g), torch.from_numpy(wp),
                            torch.from_numpy(wm), 2.0)
    for r_part, p_part in zip(ref, got):
        assert [int(x) for x in p_part] == [int(x) for x in r_part]


def test_decompose_point_as_reference():
    y = np.asarray([0.5, -0.25, 0.0, 1.0, 0.0], np.float32)
    mask = np.asarray([1, 1, 1, 1, 0], bool)
    rw = J._decompose_point(jnp.asarray(y), 4.0, jnp.asarray(mask))
    pw = P._decompose_point(torch.from_numpy(y), 4.0, torch.from_numpy(mask))
    for r_arr, p_arr in zip(rw, pw):
        assert np.array_equal(p_arr.numpy(), np.asarray(r_arr))
