import _hypothesis_compat
import numpy as np
import pytest

_hypothesis_compat.install()


@pytest.fixture(scope="session")
def appc_small():
    """Small Appendix-C synthetic dataset (train/test split)."""
    from repro.data import synthetic
    X, y = synthetic.appendix_c(m=3000, seed=0)
    return synthetic.train_test_split(X, y, test_frac=0.4, seed=0)


@pytest.fixture(scope="session")
def planted_cube():
    """[0,1]^4 points with one planted algebraic relation."""
    rng = np.random.default_rng(0)
    X = rng.uniform(0, 1, (1200, 4))
    X[:, 3] = X[:, 0] * X[:, 1] + rng.normal(0, 0.01, 1200)
    X[:, 3] = np.clip(X[:, 3], 0, 1)
    return X


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA card; run there with `pytest -m gpu tests/`",
    )
