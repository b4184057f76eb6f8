"""The plain reference agrees with itself at tiny sizes, and its judge
sees planted faults."""

import numpy as np
import pytest
import torch

from bench.harness.traffic import appendix_c, min_max_scale
from bench.reference import oavi, pipeline, prec, svm

PSI = 0.005


@pytest.fixture(scope="module")
def classes():
    X, y = appendix_c(m=3000, seed=3)
    return pipeline.scaled_classes(X, y)[2]


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 3 * 2 ** -12, -(1 + 3 * 2 ** -12), 1 + 2 ** -10])
    got = prec.tf32(x).tolist()
    assert got == [1.0, 1.0, 1 + 2 ** -10, -(1 + 2 ** -10), 1 + 2 ** -10]
    a = torch.randn(8, 5)
    assert torch.equal(prec.tf32(prec.tf32(a)), prec.tf32(a))
    assert torch.equal(prec.mm(a, a.T, "tf32"), prec.tf32(a) @ prec.tf32(a).T)


def test_border_and_pearson_order():
    assert oavi.border([(0, 0, 0)], 1, 3) == [(1, 0, 0), (0, 1, 0), (0, 0, 1)]
    O = [(0, 0), (1, 0), (0, 1), (1, 1)]
    assert oavi.border(O, 2, 2) == [(2, 0), (1, 1), (0, 2)]
    assert oavi.border(O, 3, 2) == []
    assert oavi.border(O + [(2, 0)], 3, 2) == [(3, 0), (2, 1)]
    rng = np.random.default_rng(0)
    a = rng.uniform(size=500)
    X = np.stack([a, a + 0.01 * rng.uniform(size=500), rng.uniform(size=500)], axis=1)
    # the independent feature correlates least
    assert oavi.pearson_order(X)[0] == 2


def test_fit_judged_by_its_own_judge_is_exact(classes):
    for Xc in classes:
        mdl = oavi.fit(Xc, PSI, 10, "fp64")
        assert mdl["G"] and len(mdl["O"]) > 1
        r = oavi.judge(Xc, mdl, PSI, 10)
        assert r["structure"] == []
        assert r["verdict"] == 0.0
        assert r["mse_gap"] < 1e-12 and r["coef_excess"] < 1e-15
        for g, c in zip(mdl["G"], r["coef"]):
            np.testing.assert_allclose(c, g[1], rtol=1e-12, atol=1e-12)


def test_tf32_fit_is_judged_further_off(classes):
    Xc = classes[0]
    r64 = oavi.judge(Xc, oavi.fit(Xc, PSI, 10, "fp64"), PSI, 10)
    r32 = oavi.judge(Xc, oavi.fit(Xc, PSI, 10, "tf32"), PSI, 10)
    assert r32["structure"] == []
    assert r32["mse_gap"] > 100 * max(r64["mse_gap"], 1e-14)


def test_judge_sees_planted_faults(classes):
    Xc = classes[1]
    mdl = oavi.fit(Xc, PSI, 10, "fp64")
    bad = dict(mdl, G=[(g[0], g[1] + 0.05, g[2]) for g in mdl["G"]])
    assert oavi.judge(Xc, bad, PSI, 10)["coef_excess"] > 1e-3
    bad = dict(mdl, G=[(g[0], g[1], g[2] * 0.5) for g in mdl["G"]])
    assert oavi.judge(Xc, bad, PSI, 10)["mse_gap"] > 1e-3
    bad = dict(mdl, perm=np.asarray(mdl["perm"])[::-1])
    assert oavi.judge(Xc, bad, PSI, 10)["structure"]
    # a generator's term moved into O: the border of the next degree changes
    bad = dict(mdl, O=list(mdl["O"]) + [mdl["G"][0][0]], G=mdl["G"][1:])
    assert oavi.judge(Xc, bad, PSI, 10)["structure"]
    bad = dict(mdl, G=mdl["G"][:-1])
    assert oavi.judge(Xc, bad, PSI, 10)["structure"]


def test_evaluate_is_the_generators_absolute_value():
    rng = np.random.default_rng(1)
    X = rng.uniform(size=(40, 2)).astype(np.float32)
    mdl = {"perm": np.array([1, 0]), "O": [(0, 0), (1, 0), (0, 1)],
           "G": [((2, 0), np.array([0.5, -1.0]), 0.0), ((1, 1), np.array([0.1, 0.2, 0.3]), 0.0)]}
    F = oavi.evaluate(X, mdl, [g[1] for g in mdl["G"]]).numpy()
    Z = X[:, [1, 0]].astype(np.float64)
    want0 = np.abs(Z[:, 0] ** 2 + 0.5 - Z[:, 0])
    want1 = np.abs(Z[:, 0] * Z[:, 1] + 0.1 + 0.2 * Z[:, 0] + 0.3 * Z[:, 1])
    np.testing.assert_allclose(F, np.stack([want0, want1], axis=1), rtol=1e-12)


def test_svm_separates_and_stops_on_its_tolerance():
    rng = np.random.default_rng(2)
    X = rng.normal(size=(400, 3))
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.int32)
    W, b, iters, classes = svm.fit(torch.as_tensor(X), y, 1e-4, 5000, 1e-6)
    assert classes.tolist() == [0, 1] and W.shape == (3, 2)
    assert np.mean(classes[np.argmax(X @ W + b, axis=1)] == y) > 0.97
    assert iters < 5000
    W2, b2, it2, _ = svm.fit(torch.as_tensor(X), y, 1e-4, iters, 1e-6)
    np.testing.assert_array_equal(W2, W)
    W3, _, _, _ = svm.fit(torch.as_tensor(X), y, 1e-4, 5000, 1e-6, "tf32")
    assert W3.dtype == np.float32 and np.max(np.abs(W3 - W)) < 0.05 * np.max(np.abs(W))


def test_classify_reference_judged_by_itself():
    X, y = appendix_c(m=2000, seed=5)
    idx = np.random.default_rng(0).permutation(2000)
    inputs = {"Xtr": X[idx[:1200]], "ytr": y[idx[:1200]], "Xte": X[idx[1200:]]}
    fit = {"psi": PSI, "max_degree": 10, "svm": {"lam": 1e-4, "max_iter": 200, "tol": 1e-4}}
    out = pipeline.classify(inputs, fit, "fp64", "cpu")
    nums = pipeline.judge_classify(inputs, out, fit, "cpu")
    assert nums["structure"] == []
    assert nums["feature_gap"] < 1e-12 and nums["svm_gap"] < 1e-12
    assert nums["label_flips"] == 0
    Xs = min_max_scale(inputs["Xtr"], inputs["Xte"])
    assert out["test_features"].shape == (800, sum(len(m["G"]) for m in out["models"]))
    assert Xs.dtype == np.float32
