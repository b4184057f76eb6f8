"""The port's baselines ABM and VCA, their API, the per-model transform and
their classifiers, against the JAX package on the CPU.

* ABM (``api.fit(X, "abm")``): the term book, the leading terms and the
  verdicts equal the reference's; the monic coefficients agree within rtol
  1e-3, atol 2e-4, and ``|G(Z)|`` within rtol 1e-3, atol 1e-4.  Both
  packages take the smallest eigenvector of the same fp32 extended Gram from
  two LAPACK builds, and the monic scaling divides by its leading entry:
  observed differences are at most 4.9e-5 on these sets.  Every candidate's
  eigenvalue lies at least 2.6% of psi away from psi here (printed), so no
  verdict sits in fp32 noise.
* VCA (``api.fit(X, "vca")``): the vanishing and non-vanishing counts of
  every degree equal the reference's, and ``|G(Z)|`` agrees within rtol
  1e-4, atol 1e-6 (both fit in float64 and evaluate in fp32; observed
  differences up to 5e-9).  Raw ``combo``/``proj`` arrays are not compared:
  singular vectors carry a free sign.
* The reference's behaviour tests of ``tests/test_vca_abm.py`` run on the
  port.
* F1: ``api.feature_transform`` falls back to the per-model loop where the
  models share no fused plan (VCA models, mixed widths, mixed dtypes, no
  models) and returns what the reference returns.
* Models and classifiers of either baseline load across packages.
"""

import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import abm as jabm
from repro.core import vca as jvca
from repro.core.pipeline import PipelineConfig as JConfig
from repro.core.pipeline import VanishingIdealClassifier as JClassifier
from repro_torch import api, convert
from repro_torch.core import abm, vca
from repro_torch.core.pipeline import PipelineConfig, VanishingIdealClassifier
from repro_torch.core.transform import MinMaxScaler
from repro_torch.data import synthetic

PSI = 0.005
ABM_COEF_TOL = dict(rtol=1e-3, atol=2e-4)
ABM_G_TOL = dict(rtol=1e-3, atol=1e-4)
VCA_G_TOL = dict(rtol=1e-4, atol=1e-6)
CROSS_TOL = dict(rtol=1e-5, atol=1e-6)


def _cube(seed=0, m=1200):
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 1, (m, 4))
    X[:, 3] = np.clip(X[:, 0] * X[:, 1] + rng.normal(0, 0.01, m), 0, 1)
    return X


def _classes(name):
    if name == "appc":
        X, y = synthetic.appendix_c(m=3000, seed=0)
    else:
        X, y = synthetic.uci_like(name, seed=0)
    Xs = MinMaxScaler(dtype="float32").fit_transform(X)
    return [Xs[y == c] for c in np.unique(y)]


DATASETS = {
    "cube": lambda: _cube(),
    "appc0": lambda: _classes("appc")[0],
    "appc1": lambda: _classes("appc")[1],
    "seeds0": lambda: _classes("seeds")[0],
    "seeds1": lambda: _classes("seeds")[1],
}


@pytest.fixture(scope="module")
def planted_cube():
    return _cube()


@pytest.fixture(scope="module")
def appc_split():
    X, y = synthetic.appendix_c(m=3000, seed=0)
    return synthetic.train_test_split(X, y, test_frac=0.4, seed=0)


def _lams_of(fn):
    """Run ``fn`` and return its result with every ABM candidate's smallest
    eigenvalue, in order."""
    lams = []
    inner = abm.candidate_loop

    def loop(*args):
        out = inner(*args)
        lams.extend(out[1].tolist())
        return out

    abm.candidate_loop = loop
    try:
        return fn(), lams
    finally:
        abm.candidate_loop = inner


# ---------------------------------------------------------------------------
# ABM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(DATASETS))
def test_abm_matches_reference(name):
    X = DATASETS[name]()
    port, lams = _lams_of(lambda: api.fit(X, "abm", psi=PSI, cap_terms=64, device="cpu"))
    ref = japi.fit(X, "abm", psi=PSI, cap_terms=64)
    margin = min(abs(lam - PSI) for lam in lams) / PSI
    print(f"{name}: {len(lams)} candidates, nearest eigenvalue {margin:.4f} psi from psi")
    assert margin > 1e-3
    assert port.book.terms == ref.book.terms
    assert [g.term for g in port.generators] == [g.term for g in ref.generators]
    assert [(g.parent_idx, g.var) for g in port.generators] == \
        [(g.parent_idx, g.var) for g in ref.generators]
    assert np.array_equal(port.feature_perm, ref.feature_perm)
    for g, r in zip(port.generators, ref.generators):
        assert g.coeffs.shape == r.coeffs.shape
        np.testing.assert_allclose(g.coeffs, r.coeffs, **ABM_COEF_TOL)
        assert g.mse <= PSI * (1 + 1e-6)
    np.testing.assert_allclose(port.transform(X), np.asarray(ref.transform(X)), **ABM_G_TOL)
    for key in ("border_sizes", "degrees", "termination", "num_G", "num_O", "G_plus_O", "m",
                "n"):
        assert port.stats[key] == ref.stats[key], key
    assert port.stats["eigh_calls"] == sum(port.stats["border_sizes"])
    assert port.stats["kernel_launches"]["gram_update"] == 0  # the CPU runs the plain version
    assert port.stats["api"]["method"] == "abm"


def test_abm_generators_monic_and_vanishing(planted_cube):
    model = abm.fit(planted_cube, abm.ABMConfig(psi=0.005, cap_terms=64), device="cpu")
    assert model.num_G > 0
    # acceptance is on the unit-norm polynomial; the monic one's MSE may
    # exceed psi but stays small
    assert float(model.mse(planted_cube).max()) < 0.1


def test_abm_finds_planted_relation(planted_cube):
    model = abm.fit(planted_cube, abm.ABMConfig(psi=0.005, cap_terms=64), device="cpu")
    leads = {g.term for g in model.generators}
    assert any(t[3] > 0 or (t[0] and t[1]) for t in leads)


def test_abm_capacity_exhausted_raises():
    X = np.random.default_rng(0).uniform(0, 1, (300, 12))
    with pytest.raises(RuntimeError, match="ABM capacity exhausted"):
        api.fit(X, "abm", cap_terms=64, device="cpu")
    with pytest.raises(RuntimeError, match="ABM capacity exhausted"):
        jabm.fit(X, jabm.ABMConfig(cap_terms=64))


def test_abm_float64_fit_keeps_structure(planted_cube):
    """A float64 fit (on the CPU; the card's Gram kernel is fp32 only) finds
    the float32 fit's structure on data whose eigenvalues lie far from psi."""
    f32 = api.fit(planted_cube, "abm", cap_terms=64, device="cpu")
    f64 = api.fit(planted_cube, "abm", cap_terms=64, dtype="float64", device="cpu")
    assert f64.book.terms == f32.book.terms
    assert [g.term for g in f64.generators] == [g.term for g in f32.generators]
    assert all(g.coeffs.dtype == np.float64 for g in f64.generators)
    assert f64.evaluate_G(planted_cube).dtype == torch.float64


def test_abm_sharded_backend_raises():
    X = _cube(m=200)
    with pytest.raises(ValueError, match="does not support backend='sharded'"):
        api.fit(X, "abm", backend="sharded", device="cpu")
    with pytest.raises(ValueError, match="does not support backend='sharded'"):
        api.fit(X, "vca", backend="sharded", device="cpu")


# ---------------------------------------------------------------------------
# VCA
# ---------------------------------------------------------------------------


def _vca_counts(model):
    return [model.deg1_num_vanishing] + [(b.num_vanishing, b.num_nonvanishing)
                                         for b in model.blocks]


@pytest.mark.parametrize("name", list(DATASETS))
def test_vca_matches_reference(name):
    X = DATASETS[name]()
    port = api.fit(X, "vca", psi=PSI, device="cpu")
    ref = japi.fit(X, "vca", psi=PSI)
    assert _vca_counts(port) == _vca_counts(ref)
    assert (port.num_G, port.num_F) == (ref.num_G, ref.num_F)
    assert port.sqrt_m == ref.sqrt_m
    for b, r in zip(port.blocks, ref.blocks):
        assert np.array_equal(b.pair_f, r.pair_f) and np.array_equal(b.pair_g, r.pair_g)
        assert b.proj.shape == r.proj.shape and b.combo.shape == r.combo.shape
    G = port.transform(X)
    assert G.dtype == np.float32
    np.testing.assert_allclose(G, np.asarray(ref.transform(X)), **VCA_G_TOL)
    for key in ("border_sizes", "degrees", "termination", "capped", "num_G", "num_O",
                "G_plus_O"):
        assert port.stats[key] == ref.stats[key], key
    assert len(port.stats["svd_times"]) == len(port.stats["degrees"])


def test_vca_train_eval_consistency(planted_cube):
    model = vca.fit(planted_cube, vca.VCAConfig(psi=0.005), device="cpu")
    assert model.num_G > 0
    assert float(model.mse(planted_cube).max()) <= 0.005 * (1 + 1e-4)


def test_vca_eval_new_points(planted_cube):
    model = vca.fit(planted_cube, vca.VCAConfig(psi=0.005), device="cpu")
    ref = jvca.fit(planted_cube, jvca.VCAConfig(psi=0.005))
    rng = np.random.default_rng(1)
    Z = rng.uniform(0, 1, (200, 4))
    Z[:, 3] = np.clip(Z[:, 0] * Z[:, 1], 0, 1)
    G = model.evaluate_G(Z)
    assert tuple(G.shape) == (200, model.num_G)
    assert bool(torch.isfinite(G).all())
    np.testing.assert_allclose(np.abs(G.numpy()), np.abs(ref.evaluate_G(Z)), **VCA_G_TOL)


def test_vca_is_permutation_invariant(planted_cube):
    """Monomial-agnostic methods are data-driven by construction (§1.2)."""
    perm = np.array([2, 0, 3, 1])
    a = vca.fit(planted_cube, vca.VCAConfig(psi=0.005), device="cpu")
    b = vca.fit(planted_cube[:, perm], vca.VCAConfig(psi=0.005), device="cpu")
    assert a.num_G == b.num_G
    np.testing.assert_allclose(
        np.sort(a.transform(planted_cube), axis=None),
        np.sort(b.transform(planted_cube[:, perm]), axis=None),
        rtol=5e-2, atol=5e-3,
    )


def test_vca_spurious_vanishing_on_many_features():
    """The paper's §6.2: VCA constructs many more components on
    high-dimensional data than monomial-aware methods; the port's counts are
    the reference's."""
    X = np.random.default_rng(0).uniform(0, 1, (300, 12))
    v = vca.fit(X, vca.VCAConfig(psi=0.005, max_degree=3), device="cpu")
    a = abm.fit(X, abm.ABMConfig(psi=0.005, cap_terms=256, max_degree=3), device="cpu")
    assert v.num_G >= a.num_G
    assert v.num_G == jvca.fit(X, jvca.VCAConfig(psi=0.005, max_degree=3)).num_G
    assert a.num_G == jabm.fit(X, jabm.ABMConfig(psi=0.005, cap_terms=256,
                                                  max_degree=3)).num_G


def test_vca_capped_components_match_reference():
    X = DATASETS["seeds1"]()
    cfg = dict(psi=1e-4, max_degree=4, max_components_per_degree=3)
    port = vca.fit(X, vca.VCAConfig(**cfg), device="cpu")
    ref = jvca.fit(X, jvca.VCAConfig(**cfg))
    assert port.stats["capped"] and ref.stats["capped"]
    assert _vca_counts(port) == _vca_counts(ref)
    np.testing.assert_allclose(port.transform(X), ref.transform(X), **VCA_G_TOL)


def test_vca_state_dict_layout_matches_reference(planted_cube):
    port = vca.fit(planted_cube, vca.VCAConfig(), device="cpu")
    ref = jvca.fit(planted_cube, jvca.VCAConfig())
    (pa, pm), (ra, rm) = port.to_state_dict(), ref.to_state_dict()
    assert sorted(pa) == sorted(ra)
    for k in pa:
        assert pa[k].dtype == ra[k].dtype and pa[k].shape == ra[k].shape, k
    assert set(pm) == set(rm)
    assert {k: pm[k] for k in pm if k != "stats"} == {k: rm[k] for k in rm if k != "stats"}


# ---------------------------------------------------------------------------
# Save / load across packages
# ---------------------------------------------------------------------------


def test_vca_model_round_trip_bit_identical(tmp_path, planted_cube):
    model = api.fit(planted_cube, "vca", device="cpu")
    model.save(str(tmp_path / "v"))
    back = api.load(str(tmp_path / "v"), device="cpu")
    assert isinstance(back, vca.VCAModel) and back.stats == model.stats
    assert np.array_equal(back.transform(planted_cube), model.transform(planted_cube))


def test_vca_model_loads_across_packages(tmp_path, planted_cube):
    ref = japi.fit(planted_cube, "vca")
    ref.save(str(tmp_path / "ref"))
    port = api.load(str(tmp_path / "ref"), device="cpu")
    assert isinstance(port, vca.VCAModel)
    np.testing.assert_allclose(port.transform(planted_cube),
                               np.asarray(ref.transform(planted_cube)), **CROSS_TOL)
    mine = api.fit(planted_cube, "vca", device="cpu")
    mine.save(str(tmp_path / "port"))
    theirs = japi.load(str(tmp_path / "port"))
    assert isinstance(theirs, jvca.VCAModel)
    np.testing.assert_allclose(np.asarray(theirs.transform(planted_cube)),
                               mine.transform(planted_cube), **CROSS_TOL)


def test_abm_model_loads_across_packages(tmp_path, planted_cube):
    """ABM fits are OAVIModels in both packages, saved as kind "oavi"."""
    mine = api.fit(planted_cube, "abm", cap_terms=64, device="cpu")
    mine.save(str(tmp_path / "port"))
    theirs = japi.load(str(tmp_path / "port"))
    np.testing.assert_allclose(np.asarray(theirs.transform(planted_cube)),
                               mine.transform(planted_cube), **CROSS_TOL)
    ref = japi.fit(planted_cube, "abm", cap_terms=64)
    arrays, meta = ref.to_state_dict()
    port = convert.oavi_model_from_reference(arrays, meta, device="cpu")
    np.testing.assert_allclose(port.transform(planted_cube),
                               np.asarray(ref.transform(planted_cube)), **CROSS_TOL)


def test_convert_vca_model_from_reference(planted_cube):
    ref = jvca.fit(planted_cube, jvca.VCAConfig())
    arrays, meta = ref.to_state_dict()
    port = convert.vca_model_from_reference(arrays, meta, device="cpu")
    np.testing.assert_allclose(port.transform(planted_cube), ref.transform(planted_cube),
                               **CROSS_TOL)
    with pytest.raises(ValueError, match="expected a VCA model"):
        convert.vca_model_from_reference(arrays, dict(meta, kind="oavi"), device="cpu")
    with pytest.raises(ValueError, match="expected an OAVI model"):
        convert.oavi_model_from_reference(arrays, meta, device="cpu")


# ---------------------------------------------------------------------------
# F1: the per-model transform
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def f1_data():
    X, y = synthetic.appendix_c(m=3000, seed=0)
    Xs = MinMaxScaler(dtype="float32").fit_transform(X)
    return Xs[y == 0], Xs[:50]


def _carried(ref_model):
    """The port's copy of a reference model: both packages then evaluate the
    same coefficients."""
    return convert.oavi_model_from_reference(*ref_model.to_state_dict(), device="cpu")


def test_feature_transform_mixed_widths(f1_data):
    A, Z = f1_data
    ref = [japi.fit(A), japi.fit(A[:, :2])]
    port = [_carried(m) for m in ref]
    # the per-model loop hands every model the same Z; the width-2 model
    # reads the columns its Pearson permutation names
    want = np.asarray(japi.feature_transform(ref, Z))
    got = api.feature_transform(port, Z)
    assert got.shape == want.shape == (50, 9)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, **CROSS_TOL)
    assert api.fit(A[:, :2], device="cpu").num_G + api.fit(A, device="cpu").num_G == 9


def test_feature_transform_no_models(f1_data):
    Z = f1_data[1]
    got = api.feature_transform([], Z)
    want = np.asarray(japi.feature_transform([], Z))
    assert got.shape == want.shape == (50, 0)
    assert got.dtype == want.dtype == np.float64


def test_feature_transform_mixed_dtypes(f1_data):
    """Each model evaluates in its own dtype, then the columns are cast to
    the first model's dtype (or the one asked for): the reference's rule.
    The reference evaluates its float64 model in fp32 (JAX without x64), so
    its output is fp32 where the port's is float64, and the two agree to
    fp32 rounding (rtol 1e-5, atol 1e-6)."""
    A, Z = f1_data
    ref = [japi.fit(A), japi.fit(A, dtype="float64")]
    f32, f64 = (_carried(m) for m in ref)
    assert [m.transform(Z).dtype for m in (f32, f64)] == [np.float32, np.float64]
    assert api.fit(A, dtype="float64", device="cpu").transform(Z).dtype == np.float64
    for models, refs, dtype in (([f32, f64], ref, None), ([f64, f32], ref[::-1], None),
                                ([f32, f64], ref, "float64")):
        got = api.feature_transform(models, Z, dtype=dtype)
        want = np.asarray(japi.feature_transform(refs, Z, dtype=dtype))
        assert got.shape == want.shape
        assert got.dtype == np.dtype(dtype or models[0].dtype)
        assert want.dtype == np.dtype(dtype or np.asarray(refs[0].evaluate_G(Z)).dtype)
        own = np.concatenate([m.transform(Z).astype(got.dtype) for m in models], axis=1)
        assert np.array_equal(got, own)
        np.testing.assert_allclose(got, want, **CROSS_TOL)


def test_feature_transform_vca_models_per_model_loop(f1_data, appc_split):
    Xtr, ytr = appc_split[0], appc_split[1]
    Xs = MinMaxScaler(dtype="float32").fit_transform(Xtr)
    classes = [Xs[ytr == c] for c in np.unique(ytr)]
    port = api.fit_classes(classes, "vca", device="cpu")
    ref = japi.fit_classes(classes, "vca")
    Z = f1_data[1]
    got = api.feature_transform(port, Z, batch_size=7)
    want = np.asarray(japi.feature_transform(ref, Z))
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, **VCA_G_TOL)
    assert np.array_equal(got, np.concatenate([m.transform(Z) for m in port], axis=1))


def test_fused_transform_row_stable_on_cpu(f1_data, appc_split):
    """F2 on the CPU: direct, chunked and single-row calls give the same
    bits (tests/test_torch_gpu.py holds the card)."""
    Xtr, ytr = appc_split[0], appc_split[1]
    Xs = MinMaxScaler(dtype="float32").fit_transform(Xtr)
    models = api.fit_classes([Xs[ytr == c] for c in np.unique(ytr)], device="cpu")
    Z = Xs[:300]
    direct = api.feature_transform(models, Z)
    for bs in (1, 2, 7, 256):
        assert np.array_equal(api.feature_transform(models, Z, batch_size=bs), direct), bs
    single = np.concatenate([api.feature_transform(models, Z[i:i + 1]) for i in range(40)])
    assert np.array_equal(single, direct[:40])


def test_fit_classes_baselines_run_sequentially_under_class_batch_auto(appc_split):
    """The reference batches OAVI classes only; ABM and VCA fit one class
    after another under class_batch='auto', in both packages, while OAVI
    runs the class-batched path, streamed with chunk_rows."""
    Xtr, ytr = appc_split[0], appc_split[1]
    Xs = MinMaxScaler(dtype="float32").fit_transform(Xtr)
    classes = [Xs[ytr == c] for c in np.unique(ytr)]
    for spec, kw in (("abm", dict(cap_terms=64)), ("vca", {})):
        port = api.fit_classes(classes, spec, class_batch="auto", device="cpu", **kw)
        ref = japi.fit_classes(classes, spec, class_batch="auto", **kw)
        assert [m.num_G for m in port] == [m.num_G for m in ref]
        assert all(m.stats.get("class_batch") is None for m in port)
    oavi_models = api.fit_classes(classes, "oavi", class_batch="auto", device="cpu")
    assert all(m.stats["class_batch"]["size"] == len(classes) for m in oavi_models)
    streamed = api.fit_classes(classes, "oavi", class_batch="auto", chunk_rows=1024,
                               device="cpu")
    assert all(m.stats["class_batch"]["streaming"] for m in streamed)
    assert [m.book.terms for m in streamed] == [m.book.terms for m in oavi_models]


# ---------------------------------------------------------------------------
# Classifiers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["abm", "vca"])
def baseline_classifiers(request, appc_split):
    Xtr, ytr = appc_split[0], appc_split[1]
    kw = {"cap_terms": 64} if request.param == "abm" else {}
    port = VanishingIdealClassifier(PipelineConfig(method=request.param, psi=PSI, oavi_kw=kw),
                                    device="cpu").fit(Xtr, ytr)
    ref = JClassifier(JConfig(method=request.param, psi=PSI, oavi_kw=kw,
                              class_batch="off")).fit(Xtr, ytr)
    return request.param, port, ref


def _clear(scores, margin=1e-4):
    top2 = np.sort(scores, axis=1)[:, -2:]
    return (top2[:, 1] - top2[:, 0]) > margin


def test_baseline_classifier_matches_reference(appc_split, baseline_classifiers):
    method, port, ref = baseline_classifiers
    Xte, yte = appc_split[2], appc_split[3]
    tol = ABM_G_TOL if method == "abm" else VCA_G_TOL
    feats = port.transform(Xte)
    np.testing.assert_allclose(feats, np.asarray(ref.transform(Xte)), **tol)
    assert port.stats["G_plus_O"] == ref.stats["G_plus_O"]
    assert port.stats["num_features"] == ref.stats["num_features"]
    assert port.average_degree() == ref.average_degree()
    assert port.sparsity() == ref.sparsity()
    if method == "vca":  # no term book: Table 3 reports these as 0
        assert port.average_degree() == 0.0 and port.sparsity() == 0.0
    else:
        assert port.average_degree() > 0
    clear = _clear(ref.svm.decision_function(np.asarray(ref.transform(Xte))))
    assert clear.mean() > 0.9
    assert np.array_equal(port.predict(Xte)[clear], ref.predict(Xte)[clear])
    assert abs(port.score(Xte, yte) - ref.score(Xte, yte)) <= 1 - clear.mean()


def test_baseline_classifier_save_load(tmp_path, appc_split, baseline_classifiers):
    method, port, ref = baseline_classifiers
    Xte = appc_split[2]
    port.save(str(tmp_path / "port"))
    again = VanishingIdealClassifier.load(str(tmp_path / "port"), device="cpu")
    assert again.config == port.config
    assert np.array_equal(again.transform(Xte), port.transform(Xte))
    assert np.array_equal(again.predict(Xte), port.predict(Xte))
    # saved by the port, loaded by the reference
    theirs = JClassifier.load(str(tmp_path / "port"))
    assert theirs.config.method == method
    np.testing.assert_allclose(np.asarray(theirs.transform(Xte)), port.transform(Xte),
                               **CROSS_TOL)
    # saved by the reference, loaded by the port (and through convert)
    ref.save(str(tmp_path / "ref"))
    mine = VanishingIdealClassifier.load(str(tmp_path / "ref"), device="cpu")
    arrays, meta = ref.to_state_dict()
    conv = convert.classifier_from_reference(arrays, meta, device="cpu")
    feats = np.asarray(ref.transform(Xte))
    for clf in (mine, conv):
        assert [type(m).__name__ for m in clf.models] == \
            [type(m).__name__ for m in ref.models]
        np.testing.assert_allclose(clf.transform(Xte), feats, **CROSS_TOL)
        clear = _clear(ref.svm.decision_function(feats))
        assert np.array_equal(clf.predict(Xte)[clear], ref.predict(Xte)[clear])
