"""The port's polynomial-kernel SVM (Table 3's baseline) against the JAX
package's ``repro.core.svm.PolySVM``, on the CPU.

* The same seed draws the same anchor rows in both packages.
* The masked, chunked training loop stops at the reference's iteration,
  whether the relative-gradient test or ``max_iter`` ends it.
* Decision values agree within rtol 1e-3, atol 1e-4: the same fp32
  operations, summed in another order by two BLAS builds (observed
  differences up to 1.8e-5 on values of magnitude up to 1.2), and the
  accuracy on the test split is the reference's.
"""

import numpy as np
import pytest
import torch

from repro.core import svm as jsvm
from repro_torch.core import svm
from repro_torch.core.svm import PolySVM, PolySVMConfig
from repro_torch.core.transform import MinMaxScaler
from repro_torch.data import synthetic

DEC_TOL = dict(rtol=1e-3, atol=1e-4)


def _split(name, m=None):
    if name == "appc":
        X, y = synthetic.appendix_c(m=m, seed=0)
    else:
        X, y = synthetic.uci_like(name, seed=0)
    Xtr, ytr, Xte, yte = synthetic.train_test_split(X, y, test_frac=0.4, seed=0)
    scaler = MinMaxScaler(dtype="float32").fit(Xtr)
    return scaler.transform(Xtr), ytr, scaler.transform(Xte), yte


@pytest.fixture(scope="module")
def seeds():
    return _split("seeds")


@pytest.fixture(scope="module")
def appc():
    return _split("appc", m=3000)


@pytest.mark.parametrize("cfg", [
    PolySVMConfig(tol=0.05),  # stops on the gradient test after a few steps
    PolySVMConfig(lam=0.1, tol=1e-2),  # stops after a few hundred steps
    PolySVMConfig(degree=2, lam=1e-2, tol=2e-2, max_kernel_samples=64),  # subsampled
    PolySVMConfig(degree=3, lam=1e-4, max_iter=300),  # Table 3's row, capped
], ids=["early", "hundreds", "subsampled", "capped"])
def test_polysvm_matches_reference(seeds, cfg):
    Xtr, ytr, Xte, yte = seeds
    port = PolySVM(cfg, device="cpu").fit(Xtr, ytr)
    ref = jsvm.PolySVM(jsvm.PolySVMConfig(**cfg.__dict__)).fit(Xtr, ytr)
    assert np.array_equal(port.anchors, ref.anchors)
    assert port.stats == ref.stats
    np.testing.assert_allclose(port.decision_function(Xte), ref.decision_function(Xte),
                               **DEC_TOL)
    assert port.score(Xte, yte) == ref.score(Xte, yte)


def test_polysvm_subsampled_anchors_match_reference(appc):
    """Beyond ``max_kernel_samples`` rows both packages anchor the kernel on
    the same uniform subsample (``rng.choice`` of the same seed)."""
    Xtr, ytr, Xte, yte = appc
    cfg = PolySVMConfig(max_kernel_samples=500, max_iter=400, seed=3)
    port = PolySVM(cfg, device="cpu").fit(Xtr, ytr)
    ref = jsvm.PolySVM(jsvm.PolySVMConfig(**cfg.__dict__)).fit(Xtr, ytr)
    assert port.stats["subsampled"] and port.anchors.shape == (500, Xtr.shape[1])
    assert np.array_equal(port.anchors, ref.anchors)
    assert port.stats["iters"] == ref.stats["iters"]
    np.testing.assert_allclose(port.decision_function(Xte), ref.decision_function(Xte),
                               **DEC_TOL)
    assert np.array_equal(port.predict(Xte), ref.predict(Xte))


def test_poly_kernel_matches_reference(seeds):
    Xtr = seeds[0]
    got = svm._poly_kernel(torch.as_tensor(Xtr), torch.as_tensor(Xtr[:40]), 1.0, 1.0, 3)
    want = np.asarray(jsvm._poly_kernel(Xtr, Xtr[:40], 1.0, 1.0, 3))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("check_every", [1, 5])
def test_kernel_agd_chunking_bit_identical(seeds, monkeypatch, check_every):
    """A step past the stop is masked to a no-op, so any chunk length gives
    the bits of one-step-at-a-time iteration."""
    Xtr, ytr = seeds[0], seeds[1]
    cfg = PolySVMConfig(lam=0.1, tol=1e-2)
    base = PolySVM(cfg, device="cpu").fit(Xtr, ytr)
    monkeypatch.setattr(svm, "CHECK_EVERY", check_every)
    again = PolySVM(cfg, device="cpu").fit(Xtr, ytr)
    assert again.stats["iters"] == base.stats["iters"]
    assert np.array_equal(again.A, base.A)


def test_polysvm_needs_a_card_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PolySVM(PolySVMConfig())
    assert PolySVM(PolySVMConfig(), device="cpu").device.type == "cpu"
