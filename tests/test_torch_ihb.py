"""The port's IHB state (Theorem 4.9 inverse, Cholesky factor, Gram) held
against the JAX package's ``repro.core.ihb`` on the CPU.

A chain of appends of well-conditioned columns (``b = u * 1 + 0.1 * noise``,
as ``tests/test_ihb.py`` grows them) runs through both packages in fp32.
``AtA``, ``R`` and the closed forms are held at rtol 1e-4, atol 1e-5; the
inverse ``N``, which carries kappa(G), at the reference's own fp32 tolerance
for it, max(1e-4, 1e-6 * kappa(G)) (``tests/test_ihb.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ihb as j_ihb
from repro_torch.core import ihb

TOL = dict(rtol=1e-4, atol=1e-5)


def _chain(seed, m=300, steps=6, Lcap=16):
    rng = np.random.default_rng(seed)
    cols = [np.ones(m)]
    for _ in range(steps):
        b = rng.uniform(0, 1, m) * cols[0] + 0.1 * rng.standard_normal(m)
        A = np.stack(cols, axis=1)
        q = np.zeros(Lcap, np.float32)
        q[: A.shape[1]] = A.T @ b / m
        yield q, np.float32(b @ b / m), A.shape[1]
        cols.append(b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_append_chain_matches_reference(seed):
    Lcap = 16
    port = ihb.init_state(Lcap, 1.0, torch.float32)
    ref = j_ihb.init_state(Lcap, jnp.asarray(1.0, jnp.float32), jnp.float32)
    for q, btb, ell in _chain(seed, Lcap=Lcap):
        port = ihb.append_column(port, torch.from_numpy(q), float(btb), ell)
        ref = j_ihb.append_column(ref, jnp.asarray(q), jnp.asarray(btb), jnp.asarray(ell))
        for name in ("AtA", "R"):
            np.testing.assert_allclose(getattr(port, name).numpy(),
                                       np.asarray(getattr(ref, name)), **TOL)
        # the inverse carries kappa(G): tests/test_ihb.py's tolerance for it
        G = port.AtA.numpy()[: ell + 1, : ell + 1].astype(np.float64)
        tol = max(1e-4, 1e-6 * np.linalg.cond(G))
        np.testing.assert_allclose(port.N.numpy(), np.asarray(ref.N), rtol=tol, atol=tol)
    # N is the inverse of AtA on the active block, identity beyond it
    active = ell + 1
    P = port.AtA.numpy().astype(np.float64)
    P[active:, active:] = np.eye(Lcap - active)
    np.testing.assert_allclose(port.N.numpy() @ P, np.eye(Lcap), atol=1e-3)
    assert torch.equal(port.N[active:, active:], torch.eye(Lcap - active))


@pytest.mark.parametrize("inverse_engine", ["inverse", "chol"])
def test_closed_form_matches_reference(inverse_engine):
    factors = ihb.factors_for("fast", inverse_engine)
    assert factors == j_ihb.factors_for("fast", inverse_engine)
    Lcap = 16
    port = ihb.init_state(Lcap, 1.0, torch.float32, factors=factors)
    ref = j_ihb.init_state(Lcap, jnp.asarray(1.0, jnp.float32), jnp.float32,
                           factors=factors)
    chain = list(_chain(4, Lcap=Lcap))
    for q, btb, ell in chain[:-1]:
        port = ihb.append_column(port, torch.from_numpy(q), float(btb), ell)
        ref = j_ihb.append_column(ref, jnp.asarray(q), jnp.asarray(btb), jnp.asarray(ell))
    q = chain[-1][0]
    solve, j_solve = {
        "inverse": (ihb.closed_form_inverse, j_ihb.closed_form_inverse),
        "chol": (ihb.closed_form_cholesky, j_ihb.closed_form_cholesky),
    }[inverse_engine]
    np.testing.assert_allclose(solve(port, torch.from_numpy(q)).numpy(),
                               np.asarray(j_solve(ref, jnp.asarray(q))), **TOL)


def test_gated_append_keeps_state_and_grow_embeds():
    port = ihb.init_state(8, 1.0, torch.float32)
    q, btb, ell = next(_chain(5, Lcap=8))
    same = ihb.append_column(port, torch.from_numpy(q), float(btb), ell,
                             active=torch.tensor(False))
    for name in ("AtA", "N", "R"):
        assert torch.equal(getattr(same, name), getattr(port, name))
    grown = ihb.grow_state(ihb.append_column(port, torch.from_numpy(q), float(btb), ell), 16)
    ref = j_ihb.grow_state(
        j_ihb.append_column(j_ihb.init_state(8, jnp.asarray(1.0), jnp.float32),
                            jnp.asarray(q), jnp.asarray(btb), jnp.asarray(ell)), 16)
    for name in ("AtA", "N", "R"):
        np.testing.assert_allclose(getattr(grown, name).numpy(),
                                   np.asarray(getattr(ref, name)), **TOL)
