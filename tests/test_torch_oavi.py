"""The port's OAVI fit (fast engine) held against the JAX package on the CPU.

Both packages fit the same inputs: the port through
``repro_torch.api.fit(..., device="cpu")``, the reference through
``repro.api.fit(..., backend="local")``.

Structure — the term book O and the generators' leading terms — must be
equal.  That is a fair demand only where no candidate's reference MSE lies
within ``BAND * psi`` of ``psi``: fp32 sums in another order may flip such a
verdict.  The tests record every candidate's MSE and verdict in both fits; if
a candidate lies in the band they print it and compare the verdicts up to it.

Float tolerances:

* ``inverse_engine="chol"``: coefficients and transforms allclose at rtol
  1e-4, atol 1e-5 — the tolerance of ``tests/test_distributed.py:43``, where
  two fits share the Gram statistics up to reduction order.
* ``inverse_engine="inverse"`` (Theorem 4.9): the fp32 update of
  ``N = (A^T A)^{-1}`` has conditioning kappa(A)^2, so matvecs summed in
  another order (PyTorch's CPU BLAS vs XLA) move coefficients by ~3e-4 even
  where the Grams agree bit for bit; both fp32 fits are that far from the
  float64 least-squares solution.  The rtol 1e-4, atol 1e-5 asked of the
  fit parity is not met here.  The parity test holds them only at the floor
  rtol 5e-3, atol 2e-3 — the tolerance ``tests/test_distributed.py:63`` uses
  for the same fp32 noise amplified through the inverse — and
  :func:`test_inverse_engine_as_accurate_as_reference` holds the port to
  within 2x of the reference's distance from a float64 least-squares
  witness computed by numpy alone (:func:`_lstsq_coeffs`).
"""

import numpy as np
import pytest
import torch

import repro.core.oavi as j_oavi
from repro import api as japi
from repro_torch import api, convert
from repro_torch.core import oavi
from repro_torch.core.transform import MinMaxScaler

PSI = 0.005
BAND = 1e-3
TOL = {"chol": dict(rtol=1e-4, atol=1e-5), "inverse": dict(rtol=5e-3, atol=2e-3)}


def _recording(module, log):
    """Wrap ``module.collect_degree`` to log (term, mse, accepted) per candidate."""
    inner = module.collect_degree

    def collect(book, border, accepted, mses, coeffs, generators):
        for i, (term, _, _) in enumerate(border):
            log.append((term, float(mses[i]), bool(accepted[i])))
        return inner(book, border, accepted, mses, coeffs, generators)

    return collect


_CACHE = {}


def _fit_pair(monkeypatch, name, X, ordering, ie, dtype="float32"):
    key = (name, ordering, ie, dtype)
    if key not in _CACHE:
        jlog, plog = [], []
        with monkeypatch.context() as mp:
            mp.setattr(j_oavi, "collect_degree", _recording(j_oavi, jlog))
            mp.setattr(oavi, "collect_degree", _recording(oavi, plog))
            ref = japi.fit(X, "oavi", psi=PSI, backend="local", ordering=ordering,
                           inverse_engine=ie)
            port = api.fit(X, "oavi", psi=PSI, ordering=ordering, inverse_engine=ie,
                           dtype=dtype, device="cpu")
        _CACHE[key] = (ref, port, jlog, plog)
    return _CACHE[key]


@pytest.fixture(scope="module")
def datasets(planted_cube, appc_small):
    Xtr = appc_small[0]
    return {
        "planted_cube": np.asarray(planted_cube),
        "appc_small": MinMaxScaler(dtype="float32").fit_transform(Xtr),
    }


def _compare_structure(ref, port, jlog, plog):
    """Equal verdicts for every candidate before the first one in the band;
    returns True when no candidate lies in the band (full comparison)."""
    banded = [i for i, (_, mse, _) in enumerate(jlog) if abs(mse - PSI) <= BAND * PSI]
    stop = banded[0] if banded else len(jlog)
    if banded:
        print(f"candidate in the band: {jlog[stop]}; comparing the first {stop}")
    assert [(t, a) for t, _, a in plog[:stop]] == [(t, a) for t, _, a in jlog[:stop]]
    if banded:
        return False
    assert len(plog) == len(jlog)
    assert port.book.terms == ref.book.terms
    assert [g.term for g in port.generators] == [g.term for g in ref.generators]
    return True


@pytest.mark.parametrize("ie", ["inverse", "chol"])
@pytest.mark.parametrize("ordering", ["pearson", "none"])
@pytest.mark.parametrize("name", ["planted_cube", "appc_small"])
def test_fit_parity(monkeypatch, datasets, name, ordering, ie):
    X = datasets[name]
    ref, port, jlog, plog = _fit_pair(monkeypatch, name, X, ordering, ie)
    if not _compare_structure(ref, port, jlog, plog):
        return
    assert port.num_G > 0
    for gr, gp in zip(ref.generators, port.generators):
        np.testing.assert_allclose(gp.coeffs, gr.coeffs, **TOL[ie])
    np.testing.assert_allclose(port.transform(X), ref.transform(X), **TOL[ie])
    if ref.feature_perm is None:
        assert port.feature_perm is None
    else:
        assert np.array_equal(port.feature_perm, ref.feature_perm)


def _lstsq_coeffs(model, X):
    """Every generator's coefficients as numpy's float64 least-squares
    solution over the O columns it was fitted on: the fast engine solves
    ``min_c |O c + lead|`` through the normal equations.  Only the structure
    (terms, parents, variables) comes from ``model``."""
    Z = np.asarray(X, np.float64)
    if model.feature_perm is not None:
        Z = Z[:, model.feature_perm]
    parents, vars_ = model.book.parents, model.book.vars
    O = np.ones((Z.shape[0], len(parents)))
    for i in range(1, len(parents)):
        O[:, i] = O[:, parents[i]] * Z[:, vars_[i]]
    by_len = {}
    for j, g in enumerate(model.generators):
        by_len.setdefault(len(g.coeffs), []).append(j)
    out = [None] * model.num_G
    for ell, js in by_len.items():
        lead = np.stack([O[:, model.generators[j].parent_idx]
                         * Z[:, model.generators[j].var] for j in js], axis=1)
        sol = np.linalg.lstsq(O[:, :ell], -lead, rcond=None)[0]
        for k, j in enumerate(js):
            out[j] = sol[:, k]
    return out


def _witness_err(model, witness):
    return max(np.abs(g.coeffs - w).max() for g, w in zip(model.generators, witness))


@pytest.mark.parametrize("name", ["planted_cube", "appc_small"])
def test_inverse_engine_as_accurate_as_reference(monkeypatch, datasets, name):
    """The fp32 Theorem 4.9 fits of both packages against numpy's float64
    least-squares witness: the port is no further from it than 2x the
    reference."""
    X = datasets[name]
    ref, port, jlog, plog = _fit_pair(monkeypatch, name, X, "none", "inverse")
    if not _compare_structure(ref, port, jlog, plog):
        return
    witness = _lstsq_coeffs(ref, X)
    err_ref, err_port = _witness_err(ref, witness), _witness_err(port, witness)
    print(f"{name}: reference {err_ref:.3g}, port {err_port:.3g} from float64 lstsq")
    assert err_port <= 2.0 * err_ref + 1e-6


@pytest.mark.parametrize("ie", ["inverse", "chol"])
@pytest.mark.parametrize("name", ["planted_cube", "appc_small"])
def test_float64_fit_matches_lstsq_witness(monkeypatch, datasets, name, ie):
    """The port's float64 fit solves the same least-squares problems as the
    numpy witness, to float64 accuracy: the witness computes what the fit
    computes."""
    X = datasets[name]
    _, exact, _, _ = _fit_pair(monkeypatch, name, X, "none", ie, "float64")
    assert exact.num_G > 0
    assert _witness_err(exact, _lstsq_coeffs(exact, X)) < 1e-8


@pytest.mark.parametrize("name", ["planted_cube", "appc_small"])
def test_carry_across_reference_model(datasets, name):
    """A model fitted by ``repro`` and converted computes the reference's
    transform.  Only the final product's summation order differs."""
    X = datasets[name]
    ref = japi.fit(X, "oavi", psi=PSI, backend="local")
    arrays, meta = ref.to_state_dict()
    port = convert.oavi_model_from_reference(arrays, meta, device="cpu")
    assert port.book.terms == ref.book.terms
    assert [g.term for g in port.generators] == [g.term for g in ref.generators]
    np.testing.assert_allclose(port.transform(X), ref.transform(X), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(
        port.evaluate_O(X[:, port.feature_perm]).numpy(),
        np.asarray(ref.evaluate_O(X[:, ref.feature_perm])),
    )


def test_state_dict_round_trip_bit_identical(datasets):
    X = datasets["planted_cube"]
    model = api.fit(X, psi=PSI, device="cpu")
    arrays, meta = model.to_state_dict()
    again = oavi.OAVIModel.from_state_dict(arrays, meta, device="cpu")
    assert np.array_equal(again.transform(X), model.transform(X))


def test_fused_transform_equals_per_model(datasets):
    X, Xtr = datasets["planted_cube"], datasets["appc_small"]
    models = api.fit([X[:, :3], Xtr, X[:600, 1:]], psi=PSI, device="cpu")
    fused = api.feature_transform(models, Xtr)
    per_model = np.concatenate([m.transform(Xtr) for m in models], axis=1)
    np.testing.assert_allclose(fused, per_model, rtol=1e-6, atol=1e-7)
    chunked = api.feature_transform(models, Xtr, batch_size=333)
    assert np.array_equal(chunked, fused)


def test_wavefront_equals_sequential_evaluation(datasets):
    X = datasets["appc_small"]
    model = api.fit(X, psi=PSI, ordering="none", device="cpu")
    Z = torch.from_numpy(X)
    cols = model.evaluate_O(Z)
    parents, vars_ = model.term_arrays()
    seq = torch.zeros_like(cols)
    seq[:, 0] = 1.0
    for i in range(1, len(parents)):
        seq[:, i] = seq[:, parents[i]] * Z[:, vars_[i]]
    assert torch.equal(cols, seq)


def test_fit_stats(datasets):
    model = api.fit(datasets["planted_cube"], psi=PSI, device="cpu")
    s = model.stats
    assert s["border_sizes"] and len(s["degrees"]) == len(s["degree_times"])
    assert s["termination"] in ("empty_border", "max_degree=10")
    assert s["kernel_launches"] == {"gram_update_acc": 0, "gram_update": 0,
                                    "gram_update_acc_batched": 0,
                                    "ihb_update": 0, "ihb_degree": 0,
                                    "ihb_update_batched": 0, "ihb_degree_batched": 0,
                                    "flash_attention": 0}
    assert s["time_total"] > 0 and s["api"]["device"] == "cpu"


# ---------------------------------------------------------------------------
# The paper's convex-oracle variants (engine='oracle') and WIHB
# ---------------------------------------------------------------------------
#
# Each variant's fit on class 0 of the ``appc_small`` training split (894
# rows, min-max scaled) against ``repro.api.fit`` with the same spec.
# Verdicts, term book and leading terms must be equal (up to the band, as
# above), and ``stats["solver_iters"]`` is compared per degree.  Coefficients:
#
# * IHB-warm variants whose closed-form warm start fires a certificate at
#   iteration 0 (``cgavi-ihb``, ``agdavi-ihb`` here: 0 iterations in both
#   packages) return that closed form, so they are held at the fast engine's
#   tolerance for the inverse engine in use (``TOL``).
# * The cold CG and AGD variants take the same steps as the reference
#   (equal iteration counts), each step's sums in another order: rtol 1e-4,
#   atol 1e-5 (measured 1.2e-7 and 5.4e-7).
# * PCG and BPCG runs split at near-ties of their vertex choice (see
#   ``tests/test_torch_oracles.py``) and stop at the first iterate whose MSE
#   is at most psi, which lies at another point of another path: their
#   coefficients differ by up to 4.4e-2 here, so they are held by what the
#   oracle promises instead: every generator vanishes on the data, MSE at
#   most psi (1 + 1e-3), as ``tests/test_oavi.py`` holds the reference's.
#   Their iteration counts are held within a factor 2 per degree (measured:
#   45 vs 46, 203 vs 204, 126 vs 124).

VARIANTS = ["cgavi-ihb", "agdavi-ihb", "bpcgavi-wihb", "bpcgavi", "pcgavi",
            "cgavi", "agdavi"]
WARM = ("cgavi-ihb", "agdavi-ihb", "bpcgavi-wihb")
SPLITTING = ("bpcgavi-wihb", "bpcgavi", "pcgavi")  # PCG / BPCG paths
SAME_STEPS_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def appc_class0(appc_small):
    Xtr, ytr = appc_small[0], appc_small[1]
    return MinMaxScaler(dtype="float32").fit_transform(Xtr)[ytr == 0]


def _variant_pair(monkeypatch, key, X, spec, ref_kw=None, port_kw=None):
    if key not in _CACHE:
        jlog, plog = [], []
        with monkeypatch.context() as mp:
            mp.setattr(j_oavi, "collect_degree", _recording(j_oavi, jlog))
            mp.setattr(oavi, "collect_degree", _recording(oavi, plog))
            ref = japi.fit(X, spec, psi=PSI, backend="local", **(ref_kw or {}))
            port = api.fit(X, spec, psi=PSI, device="cpu", **(port_kw or ref_kw or {}))
        _CACHE[key] = (ref, port, jlog, plog)
    return _CACHE[key]


def _iters_close(port_iters, ref_iters, exact):
    if exact:
        assert port_iters == ref_iters
        return
    assert len(port_iters) == len(ref_iters)
    for p, r in zip(port_iters, ref_iters):
        assert (p == 0) == (r == 0) and r / 2 <= p <= 2 * r, (port_iters, ref_iters)


def _assert_vanish(model, X):
    assert float(model.mse(X).max()) <= PSI * (1 + 1e-3)


@pytest.mark.parametrize("variant,ie", [(v, "inverse") for v in VARIANTS]
                         + [(v, "chol") for v in WARM])
def test_oracle_variant_parity(monkeypatch, appc_class0, variant, ie):
    X = appc_class0
    ref, port, jlog, plog = _variant_pair(
        monkeypatch, ("appc_class0", variant, ie), X, f"oavi:{variant}",
        dict(inverse_engine=ie))
    if not _compare_structure(ref, port, jlog, plog):
        return
    assert port.num_G > 0
    _iters_close(port.stats["solver_iters"], ref.stats["solver_iters"],
                 exact=variant not in SPLITTING)
    if variant in SPLITTING:
        _assert_vanish(port, X)
        _assert_vanish(ref, X)
        return
    tol = TOL[ie] if variant in WARM else SAME_STEPS_TOL
    for gr, gp in zip(ref.generators, port.generators):
        np.testing.assert_allclose(gp.coeffs, gr.coeffs, **tol)
    np.testing.assert_allclose(port.transform(X), ref.transform(X), **tol)


@pytest.mark.parametrize("variant", ["cgavi-ihb", "agdavi-ihb"])
def test_inf_guard_parity(monkeypatch, datasets, variant):
    """(INF) guard: with tau = 3 the closed-form warm starts of planted_cube's
    degree-2 candidates leave the l1 ball of radius 2, IHB turns off for the
    rest of the degree and the oracle solves cold.  Both packages trip it at
    the same candidate: equal iteration counts (in the last degree 0 with
    the default tau, where every warm start is a certificate) and the same
    steps afterwards (``SAME_STEPS_TOL``; measured 1.2e-7, 7.6e-6)."""
    X = datasets["planted_cube"]
    kw = dict(solver_kw={"tau": 3.0})
    ref, port, jlog, plog = _variant_pair(monkeypatch, ("planted", variant, "tau3"),
                                          X, f"oavi:{variant}", kw)
    assert _compare_structure(ref, port, jlog, plog)
    assert port.stats["solver_iters"] == ref.stats["solver_iters"]
    default = api.fit(X, f"oavi:{variant}", psi=PSI, device="cpu")
    assert default.stats["solver_iters"][-1] == 0 < port.stats["solver_iters"][-1]
    for gr, gp in zip(ref.generators, port.generators):
        np.testing.assert_allclose(gp.coeffs, gr.coeffs, **SAME_STEPS_TOL)


def test_fast_engine_with_wihb(monkeypatch, datasets):
    """engine='fast' + wihb (``tests/test_oavi.py::
    test_fast_engine_with_wihb_resolve``): closed-form verdicts, a cold BPCG
    re-solve of every accepted generator on the Gram ``AtA`` the slimmed state
    keeps for it.  Same structure as the fast fit and as the reference's,
    every generator vanishing; BPCG counts within a factor 2."""
    X = datasets["planted_cube"]
    ref_cfg = j_oavi.OAVIConfig(psi=PSI, wihb=True)
    port_cfg = oavi.OAVIConfig(psi=PSI, wihb=True)
    assert port_cfg.ihb_factors() == ("ata", "n")
    ref, port, jlog, plog = _variant_pair(monkeypatch, ("planted", "fast+wihb"), X,
                                          "oavi", dict(config=ref_cfg),
                                          dict(config=port_cfg))
    assert _compare_structure(ref, port, jlog, plog)
    fast = api.fit(X, "oavi", psi=PSI, device="cpu")
    assert [g.term for g in port.generators] == [g.term for g in fast.generators]
    _iters_close(port.stats["solver_iters"], ref.stats["solver_iters"], exact=False)
    _assert_vanish(port, X)


def test_fast_engine_routes_to_degree_loop(monkeypatch, datasets):
    """Only the fast engine without WIHB on the inverse engine runs the
    degree kernel's entry point (one call per degree); every other
    configuration runs the eager candidate loop."""
    X = datasets["appc_small"]
    calls = []
    inner = oavi.kernel_ops.ihb_degree
    monkeypatch.setattr(oavi.kernel_ops, "ihb_degree",
                        lambda *a, **k: calls.append(1) or inner(*a, **k))
    fast = api.fit(X, "oavi", psi=PSI, device="cpu")
    assert len(calls) == len(fast.stats["degrees"])
    assert fast.stats["solver_iters"] == [0] * len(fast.stats["degrees"])
    for spec, kw in (("oavi:cgavi-ihb", {}), ("oavi", {"inverse_engine": "chol"}),
                     ("oavi", {"config": oavi.OAVIConfig(psi=PSI, wihb=True)})):
        calls.clear()
        api.fit(X, spec, psi=PSI, device="cpu", **kw)
        assert not calls, spec


@pytest.mark.parametrize("name", ["planted_cube", "appc_small"])
def test_eager_loop_equals_degree_loop_plain(monkeypatch, datasets, name):
    """The eager candidate loop on the fast engine and the degree kernel's
    plain version (``kernels/ref.ihb_degree_ref``) give the same bits: the
    same closed form, reduction and in-place Theorem 4.9 update."""
    X = datasets[name]
    cfg = oavi.OAVIConfig(psi=PSI)
    by_kernel_entry = oavi.fit(X, cfg, device="cpu")

    def eager_step(c, QL_raw, C_raw, state, ell0, K, m_total):
        inv_m = torch.tensor(np.float32(1.0) / np.float32(m_total))
        *out, state, _ = oavi._candidate_loop(c, QL_raw * inv_m, C_raw * inv_m,
                                              state, ell0, K)
        return oavi.DegreeResult(*(t.numpy() for t in out)), state

    monkeypatch.setattr(oavi, "stats_step", eager_step)
    eager = oavi.fit(X, cfg, device="cpu")
    assert by_kernel_entry.num_G > 0
    assert [g.term for g in eager.generators] == [g.term for g in by_kernel_entry.generators]
    for ga, gb in zip(by_kernel_entry.generators, eager.generators):
        assert np.array_equal(ga.coeffs, gb.coeffs) and ga.mse == gb.mse


@pytest.mark.parametrize("variant", VARIANTS)
def test_every_variant_runs_through_the_api(variant):
    X = np.random.default_rng(1).uniform(0, 1, (300, 2))
    model = api.fit(X, f"oavi:{variant}", psi=0.05, device="cpu")
    assert model.num_O >= 1
    assert len(model.stats["solver_iters"]) == len(model.stats["degrees"])
    assert model.stats["api"]["method"] == f"oavi:{variant}"
