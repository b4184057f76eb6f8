"""Algorithm 2 in the port (``VanishingIdealClassifier``) against the JAX
package's, on the CPU, on the ``appc_small`` fixture.

The reference runs with ``class_batch="off"`` (sequential per-class fits, as
the port does).  Tolerances:

* features: the per-class fits use the Theorem 4.9 inverse engine, whose
  fp32 coefficients move by ~3e-4 between summation orders (see
  ``tests/test_torch_oavi.py``); features are held at the same rtol 5e-3,
  atol 2e-3 as those coefficients;
* SVM weights: FISTA runs its full 10,000 fp32 iterations here (the stopping
  test does not fire), and the products' summation order differs, so W and b
  agree to a small share of their largest entry: rtol 5e-3, atol
  ``5e-3 * max|W|`` (measured ~1e-3 of max|W|);
* predictions: equal for every test sample whose reference decision margin
  (the gap between the two class scores) is at least ``EPS``; at most the
  samples below ``EPS`` may differ.
"""

import dataclasses

import numpy as np
import pytest

from repro.core.pipeline import PipelineConfig as JConfig
from repro.core.pipeline import VanishingIdealClassifier as JClassifier
from repro.core.svm import LinearSVM as JLinearSVM
from repro_torch import convert
from repro_torch.core.pipeline import PipelineConfig, VanishingIdealClassifier
from repro_torch.core.svm import LinearSVM

FEAT_TOL = dict(rtol=5e-3, atol=2e-3)
EPS = 0.05


@pytest.fixture(scope="module")
def fitted(appc_small):
    Xtr, ytr, Xte, yte = appc_small
    ref = JClassifier(JConfig(method="fast", psi=0.005, class_batch="off")).fit(Xtr, ytr)
    port = VanishingIdealClassifier(PipelineConfig(method="fast", psi=0.005),
                                    device="cpu").fit(Xtr, ytr)
    return ref, port


def _assert_w_close(W, W_ref):
    scale = float(np.abs(W_ref).max())
    np.testing.assert_allclose(W, W_ref, rtol=5e-3, atol=5e-3 * scale)


def _assert_predictions(pred, pred_ref, scores_ref):
    top2 = np.sort(scores_ref, axis=1)[:, -2:]
    margin = top2[:, 1] - top2[:, 0]
    differ = pred != pred_ref
    assert not np.any(differ & (margin >= EPS)), margin[differ]
    assert differ.sum() <= (margin < EPS).sum()


def test_per_class_structure_equal(fitted):
    ref, port = fitted
    assert np.array_equal(port.classes_, ref.classes_)
    assert len(port.models) == len(ref.models)
    for mp, mr in zip(port.models, ref.models):
        assert mp.book.terms == mr.book.terms
        assert [g.term for g in mp.generators] == [g.term for g in mr.generators]


def test_features_allclose(fitted, appc_small):
    ref, port = fitted
    Xte = appc_small[2]
    np.testing.assert_allclose(port.transform(Xte), ref.transform(Xte), **FEAT_TOL)


def test_svm_head_allclose(fitted):
    ref, port = fitted
    _assert_w_close(port.svm.W, ref.svm.W)
    _assert_w_close(port.svm.b, ref.svm.b)
    assert port.svm.stats["nnz"] == ref.svm.stats["nnz"]


def test_predictions_and_score(fitted, appc_small):
    ref, port = fitted
    Xte, yte = appc_small[2], appc_small[3]
    scores_ref = ref.svm.decision_function(ref.transform(Xte))
    _assert_predictions(port.predict(Xte), ref.predict(Xte), scores_ref)
    assert port.score(Xte, yte) > 0.8
    s = port.stats
    assert s["num_features"] == sum(m.num_G for m in port.models)
    assert s["G_plus_O"] == ref.stats["G_plus_O"]


def test_linear_svm_on_same_features(fitted, appc_small):
    """The two SVM heads on identical features."""
    ref, _ = fitted
    Xtr, ytr = appc_small[0], appc_small[1]
    feats = ref.transform(Xtr)
    a = JLinearSVM().fit(feats, ytr)
    b = LinearSVM(device="cpu").fit(feats, ytr)
    _assert_w_close(b.W, a.W)
    _assert_w_close(b.b, a.b)
    assert b.stats["iters"] == a.stats["iters"]


def test_linear_svm_stops_on_tol():
    """A separable problem stops before max_iter, near the reference's count:
    the stopping test compares an fp32 step size with ``tol``, so the two
    orders of summation cross it within 1% of each other."""
    rng = np.random.default_rng(0)
    X = rng.uniform(0, 1, (200, 3)).astype(np.float32)
    y = (X[:, 0] > 0.5).astype(np.int32)
    from repro.core.svm import LinearSVMConfig as JSVMConfig
    from repro_torch.core.svm import LinearSVMConfig

    a = JLinearSVM(JSVMConfig(tol=1e-3)).fit(X, y)
    b = LinearSVM(LinearSVMConfig(tol=1e-3), device="cpu").fit(X, y)
    assert 0 < b.stats["iters"] < 10_000
    assert abs(b.stats["iters"] - a.stats["iters"]) <= 0.01 * a.stats["iters"]
    _assert_w_close(b.W, a.W)


def test_classifier_carry_across(fitted, appc_small):
    """The reference's fitted classifier, converted, predicts as it does."""
    ref, _ = fitted
    Xte = appc_small[2]
    arrays, meta = ref.to_state_dict()
    port = convert.classifier_from_reference(arrays, meta, device="cpu")
    feats_ref = ref.transform(Xte)
    np.testing.assert_allclose(port.transform(Xte), feats_ref, rtol=1e-5, atol=1e-6)
    scores_ref = ref.svm.decision_function(feats_ref)
    _assert_predictions(port.predict(Xte), ref.predict(Xte), scores_ref)


def test_unported_classifier_parts_raise(fitted):
    """Only the serving engine is still to port (save/load: see
    ``tests/test_torch_checkpoint.py``)."""
    _, port = fitted
    with pytest.raises(NotImplementedError, match="item 13"):
        port.attach_engine()


# ---------------------------------------------------------------------------
# Algorithm 2 with the paper's own generator method, CGAVI-IHB
# ---------------------------------------------------------------------------
#
# The paper's configuration (``configs/oavi_paper.pipeline``) fits its
# generators with CGAVI-IHB.  Almost every closed-form warm start fires a
# certificate at iteration 0, so the generators are the inverse engine's
# closed forms and are held as the fast engine's are.  On class 1, degree 2,
# warm starts whose FW gap lies near ``eps = 0.01 psi`` take CG steps: the
# inverse engine's ~3e-4 coefficient spread between the packages (see
# ``tests/test_torch_oavi.py``) moves that gap, and the port takes 16 steps
# where the reference takes 87.  So the test holds which degrees iterate,
# not how far; the coefficients stay within the features' tolerance.


@pytest.fixture(scope="module")
def fitted_cgavi(appc_small):
    from repro.configs import oavi_paper as j_paper
    from repro_torch.configs import oavi_paper

    Xtr, ytr = appc_small[0], appc_small[1]
    jcfg = dataclasses.replace(j_paper.pipeline(), class_batch="off")
    ref = JClassifier(jcfg).fit(Xtr, ytr)
    port = VanishingIdealClassifier(oavi_paper.pipeline(), device="cpu").fit(Xtr, ytr)
    return ref, port


def test_paper_config_matches_reference():
    from repro.configs import oavi_paper as j_paper
    from repro_torch.configs import oavi_paper

    for name in ("PSI_DEFAULT", "TAU_DEFAULT", "EPS_FRAC", "MAX_SOLVER_ITER"):
        assert getattr(oavi_paper, name) == getattr(j_paper, name)
    for build in ("cgavi_ihb", "bpcgavi_wihb"):
        mine, ref = getattr(oavi_paper, build)(), getattr(j_paper, build)()
        assert dataclasses.asdict(mine.solver) == dataclasses.asdict(ref.solver)
        for f in ("psi", "engine", "ihb", "wihb", "inverse_engine"):
            assert getattr(mine, f) == getattr(ref, f)
    mine, ref = oavi_paper.pipeline(), j_paper.pipeline()
    assert (mine.method, mine.psi, mine.svm.lam) == (ref.method, ref.psi, ref.svm.lam)


def test_cgavi_ihb_classifier_matches_reference(fitted_cgavi, appc_small):
    ref, port = fitted_cgavi
    Xte, yte = appc_small[2], appc_small[3]
    for mp, mr in zip(port.models, ref.models):
        assert mp.book.terms == mr.book.terms
        assert [g.term for g in mp.generators] == [g.term for g in mr.generators]
        assert ([i == 0 for i in mp.stats["solver_iters"]]
                == [i == 0 for i in mr.stats["solver_iters"]])
        assert mp.stats["api"]["method"] == "oavi:cgavi-ihb"
    np.testing.assert_allclose(port.transform(Xte), ref.transform(Xte), **FEAT_TOL)
    scores_ref = ref.svm.decision_function(ref.transform(Xte))
    _assert_predictions(port.predict(Xte), ref.predict(Xte), scores_ref)
    assert port.score(Xte, yte) > 0.8
