"""The port's class-batched OAVI fit (``repro_torch.core.class_batch``) on the CPU.

Inside the port, bit for bit: a batched fit's models equal the port's own
sequential fits (``oavi.fit``) at matched capacity, for the five engines of
``tests/test_class_batch.py`` (``fast``, ``fast`` + WIHB, oracle BPCG + IHB,
cold oracle CG, oracle AGD + IHB); the batched plain kernel versions equal
their per-class calls; a finished class's lanes are no-ops.  Against the JAX
package: the planner equals the reference's on drawn size lists, and the
batched fits match ``repro.core.class_batch.fit_classes`` /
``repro.api.fit_classes(..., class_batch="auto")`` (and, for the oracle
engines, the reference's sequential fits: its own batched oracle path is not
bit-stable under jax 0.9, ``tests/test_oracles.py::
test_scheduled_vmap_bit_identity``) in structure, coefficients by the
rules of ``tests/test_torch_oavi.py``:

* the Theorem 4.9 inverse engine (the fast engine, and the IHB-warm AGD):
  its fp32 update amplifies summation-order noise by kappa(A)^2, and on
  these 256-row classes the two packages' coefficients differ by up to
  3.9e-3 (class 1 of ``_classes(3, 256, seed=21)``), past the parity floor
  rtol 5e-3, atol 2e-3 that ``tests/test_torch_oavi.py`` holds on its
  larger sets.  So they are held as ``test_inverse_engine_as_accurate_as_
  reference`` holds them: the port no further from numpy's float64
  least-squares witness than 2x the reference (there the port is 1.7e-3
  from it, the reference 4.8e-3);
* cold CG takes the same steps in both packages: rtol 1e-4, atol 1e-5;
* PCG and BPCG solves split at near-ties of their vertex choice between the
  frameworks, so their generators are held by what the oracle promises:
  MSE at most psi (1 + 1e-3).

The cold-CG case runs ``max_iter=1000`` (both sides): the batched fit
replays every escalation of the shared budget from the degree's start, and
at the default 10,000 the case takes ~40 s on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro import api as japi
from repro.core import class_batch as j_cb
from repro.core import oavi as j_oavi
from repro.core.oavi import OAVIConfig as JConfig
from repro.core.oracles import OracleConfig as JOracle
from repro.core.pipeline import PipelineConfig as JPipeConfig
from repro.core.pipeline import VanishingIdealClassifier as JClassifier
from repro_torch import api
from repro_torch.core import class_batch, oavi
from repro_torch.core.oavi import OAVIConfig
from repro_torch.core.oracles import OracleConfig
from repro_torch.core.pipeline import PipelineConfig, VanishingIdealClassifier
from repro_torch.data import synthetic
from repro_torch.kernels import ops

from test_torch_oavi import _lstsq_coeffs, _witness_err

PSI = 0.005
CFG = OAVIConfig(psi=PSI, engine="fast", cap_terms=64)
INV_TOL = dict(rtol=5e-3, atol=2e-3)  # the classifier's features
SAME_STEPS_TOL = dict(rtol=1e-4, atol=1e-5)
VANISH = 1 + 1e-3

# the five engines of tests/test_class_batch.py::test_batched_oracle_engines_bit_exact
ENGINES = {
    "fast": dict(engine="fast"),
    "fast-wihb": dict(engine="fast", wihb=True),
    "bpcg-ihb": dict(engine="oracle", solver=("bpcg", {}), ihb=True),
    "cg-cold": dict(engine="oracle", solver=("cg", {"max_iter": 1000}), ihb=False),
    "agd-ihb": dict(engine="oracle", solver=("agd", {}), ihb=True),
}


def _config(name, package="port"):
    kw = dict(ENGINES[name])
    solver = kw.pop("solver", ("bpcg", {}))
    if package == "port":
        return OAVIConfig(psi=PSI, cap_terms=64, solver=OracleConfig(name=solver[0], **solver[1]),
                          **kw)
    return JConfig(psi=PSI, cap_terms=64, solver=JOracle(name=solver[0], **solver[1]), **kw)


def _classes(k, m, n=4, seed=0):
    """``tests/test_class_batch.py::_classes``."""
    return [
        np.clip(synthetic._planted_class(np.random.default_rng(seed + c), m, n,
                                         degree=2 + (c % 2)), 0, 1).astype(np.float32)
        for c in range(k)
    ]


def _assert_bit_exact(a, b):
    assert a.book.terms == b.book.terms
    assert [g.term for g in a.generators] == [g.term for g in b.generators]
    for ga, gb in zip(a.generators, b.generators):
        assert np.array_equal(ga.coeffs, gb.coeffs), ga.term
        assert ga.mse == gb.mse, ga.term


def _assert_structure(a, b):
    assert a.book.terms == b.book.terms
    assert [g.term for g in a.generators] == [g.term for g in b.generators]


def _seq(Xs, cfg):
    return [oavi.fit(X, cfg, device="cpu") for X in Xs]


# ---------------------------------------------------------------------------
# The gate and the planner
# ---------------------------------------------------------------------------


def test_batchable_gate_matches_reference():
    for kw in (dict(), dict(engine="oracle"), dict(engine="fast", wihb=True),
               dict(engine="fast", inverse_engine="chol"),
               dict(engine="oracle", inverse_engine="chol")):
        assert oavi.class_batchable(OAVIConfig(**kw)) == j_oavi.class_batchable(JConfig(**kw))
    assert not oavi.class_batchable(OAVIConfig(inverse_engine="chol"))
    with pytest.raises(ValueError, match="class-batchable"):
        class_batch.fit_classes([np.zeros((4, 2))], OAVIConfig(inverse_engine="chol"),
                                device="cpu")
    assert class_batch.needs_solver_schedule(OAVIConfig(engine="oracle"))
    assert class_batch.needs_solver_schedule(OAVIConfig(wihb=True))
    assert not class_batch.needs_solver_schedule(CFG)


@settings(max_examples=300, deadline=None)
@given(st.lists(st.integers(min_value=1, max_value=200_000), min_size=0, max_size=24),
       st.sampled_from([1.5, 2.0, 3.0]))
def test_planner_matches_reference(sizes, pad_limit):
    assert class_batch.class_buckets(sizes) == j_cb.class_buckets(sizes)
    assert (class_batch.plan_class_groups(sizes, pad_limit)
            == j_cb.plan_class_groups(sizes, pad_limit))


def test_planner_cases():
    """``tests/test_class_batch.py``'s fixed cases, and the skewed regime of
    chip_smoke.py phase 9b."""
    assert class_batch.class_buckets([64, 70, 800]) == {1024: [2], 128: [0, 1]}
    assert class_batch.plan_class_groups([256, 250, 17]) == [(256, [0, 1, 2])]
    plans = class_batch.plan_class_groups([4096, 4000, 100, 90, 80])
    assert [idxs for _, idxs in plans] == [[0, 1], [2, 3, 4]]
    sizes = synthetic.lognormal_sizes(16, 4096, seed=16)
    plans = class_batch.plan_class_groups(sizes)
    assert plans == j_cb.plan_class_groups(sizes)
    assert sorted(i for _, idxs in plans for i in idxs) == list(range(16))
    assert all(len(idxs) >= 2 for _, idxs in plans)


def test_multiclass_data_identical():
    from repro.data import synthetic as j_synth

    sizes = synthetic.lognormal_sizes(16, 4096, seed=16)
    assert sizes == j_synth.lognormal_sizes(16, 4096, seed=16)
    X, y = synthetic.multiclass_planted(sizes[:5], n=4, seed=116)
    JX, Jy = j_synth.multiclass_planted(sizes[:5], n=4, seed=116)
    assert np.array_equal(X, JX) and np.array_equal(y, Jy)


# ---------------------------------------------------------------------------
# The batched plain kernel versions against their per-class calls
# ---------------------------------------------------------------------------


def test_gram_batched_plain_equals_per_class():
    rng = np.random.default_rng(0)
    k, m, L, n, K = 3, 700, 16, 4, 12
    A = torch.from_numpy(rng.uniform(0, 1, (k, m, L)).astype(np.float32))
    X = torch.from_numpy(rng.uniform(0, 1, (k, m, n)).astype(np.float32))
    p = torch.from_numpy(rng.integers(0, L, (k, K)))
    v = torch.from_numpy(rng.integers(0, n, (k, K)))
    acc = (torch.rand(k, L, K), torch.rand(k, K, K))
    for carry in (None, acc):
        QL, C = ops.gram_accumulate_batched(A, X, p, v, carry)
        assert QL.shape == (k, L, K) and C.shape == (k, K, K)
        for c in range(k):
            one = ops.gram_accumulate(A[c], X[c], p[c], v[c],
                                      None if carry is None else (acc[0][c], acc[1][c]))
            assert torch.equal(QL[c], one[0]) and torch.equal(C[c], one[1])


def test_ihb_update_batched_plain_equals_per_class():
    rng = np.random.default_rng(1)
    k, L = 4, 16
    N0 = torch.eye(L).repeat(k, 1, 1)
    ell = torch.tensor([3, 5, 1, 7], dtype=torch.int32)
    q = torch.zeros(k, L)
    for c in range(k):
        e = int(ell[c])
        G = rng.standard_normal((4 * L, e + 1))
        G = torch.from_numpy((G.T @ G / (4 * L)).astype(np.float32))
        N0[c, :e, :e] = torch.linalg.inv(G[:e, :e])
        q[c, :e] = G[:e, e]
    btb = torch.tensor([2.0, 1.5, 3.0, 1.1])
    active = torch.tensor([True, False, True, True])
    N = N0.clone()
    ops.ihb_update_batched_(N, q, btb, ell, active=active)
    for c in range(k):
        one = ops.ihb_update(N0[c], q[c], btb[c], ell[c], active=active[c])
        assert torch.equal(N[c], one)
    assert torch.equal(N[1], N0[1])  # the inactive class: untouched


def test_ihb_degree_batched_plain_equals_per_class():
    from test_torch_gpu import degree_inputs

    Lcap, Kcap = 64, 32
    shapes = [(4, 20), (10, 0), (1, 32)]  # (ell0, K); a done class has K = 0
    ins = []
    for c, (ell0, K) in enumerate(shapes):
        appended = np.random.default_rng(c).uniform(size=max(K, 1)) < 0.5
        ins.append(degree_inputs(c, Lcap, ell0, max(K, 1), appended[:max(K, 1)], Kcap))
    QLt, C, N0 = (torch.from_numpy(np.stack([x[i] for x in ins])) for i in range(3))
    N = N0.clone()
    out = ops.ihb_degree_batched(QLt, C, N, [s[0] for s in shapes], PSI, [s[1] for s in shapes])
    assert out[0].shape == (3, 32) and out[2].shape == (3, 32, Lcap)
    for c, (ell0, K) in enumerate(shapes):
        if K == 0:
            assert torch.equal(N[c], N0[c]) and int(out[4][c]) == ell0
            assert not out[0][c].any() and bool((out[3][c] == Lcap).all())
            continue
        Nc = N0[c].clone()
        one = ops.ihb_degree(QLt[c], C[c], Nc, ell0, PSI, K)
        for got, want in zip(out[:4], one[:4]):
            assert torch.equal(got[c, :K], want)
        assert int(out[4][c]) == int(one[4]) and torch.equal(N[c], Nc)


# ---------------------------------------------------------------------------
# Batched against the port's sequential fit, bit for bit
# ---------------------------------------------------------------------------


def test_equal_pow2_sizes_bit_exact():
    """k = 4 classes of 512 rows: no row padding; every model is the
    sequential fit's bit for bit, and the group made one launch-free CPU
    degree loop (the plain versions)."""
    Xs = _classes(k=4, m=512)
    seq = _seq(Xs, CFG)
    bat = class_batch.fit_classes(Xs, CFG, device="cpu")
    assert all(m.num_G > 0 for m in bat)
    for s, b in zip(seq, bat):
        _assert_bit_exact(s, b)
        assert b.stats["degrees"] == s.stats["degrees"]
        assert b.stats["border_sizes"] == s.stats["border_sizes"]
    cb = bat[0].stats["class_batch"]
    assert cb["size"] == 4 and cb["m_cap"] == 512 and cb["index"] == 0
    assert all(sum(m.stats["kernel_launches"].values()) == 0 for m in bat)


_ENGINE_CACHE = {}


def _engine_fits(name):
    if name not in _ENGINE_CACHE:
        Xs = _classes(k=3, m=256, seed=21)
        cfg = _config(name)
        _ENGINE_CACHE[name] = (Xs, _seq(Xs, cfg), class_batch.fit_classes(Xs, cfg, device="cpu"))
    return _ENGINE_CACHE[name]


@pytest.mark.parametrize("name", list(ENGINES))
def test_engines_batched_equal_sequential(name):
    """The five engines at k = 3, m = 256: bit for bit; the oracle and WIHB
    engines ran the shared fixed schedule, escalated until every class's
    solves converged."""
    Xs, seq, bat = _engine_fits(name)
    for s, b in zip(seq, bat):
        _assert_bit_exact(s, b)
        assert b.stats["solver_iters"] == s.stats["solver_iters"]
    st0 = bat[0].stats
    if class_batch.needs_solver_schedule(_config(name)):
        assert st0["solver_schedule_len"] is not None
        if any(max(s.stats["solver_iters"]) > 0 for s in seq):
            assert st0["solver_escalations"] >= 1 and st0["solver_schedule_len"] >= 1
    else:
        assert st0["solver_schedule_len"] is None and st0["solver_escalations"] == 0


def test_uneven_sizes_matched_capacity():
    """Uneven sizes (the reference's [300, 500, 1003, 2048]): every class is
    bit-exact against a k = 1 batched run at the same m_cap, and, because
    the port's Gram adds zero-row blocks as exact zeros, against the
    unpadded sequential fit as well."""
    sizes = [300, 500, 1003, 2048]
    Xs = [np.clip(synthetic._planted_class(np.random.default_rng(7 + i), m, 4), 0, 1)
          .astype(np.float32) for i, m in enumerate(sizes)]
    bat = class_batch.fit_classes(Xs, CFG, device="cpu")
    m_cap = bat[0].stats["class_batch"]["m_cap"]
    assert m_cap == 2048
    for X, b in zip(Xs, bat):
        _assert_bit_exact(class_batch.fit_classes([X], CFG, m_cap=m_cap, device="cpu")[0], b)
        _assert_bit_exact(oavi.fit(X, CFG, device="cpu"), b)


def test_done_masking_early_vs_late_termination():
    """One class ends at degree 1, the other runs to max_degree = 3: the
    finished class rides along as a no-op and both equal their sequential
    fits."""
    rng = np.random.default_rng(0)
    cfg = OAVIConfig(psi=1e-5, engine="fast", cap_terms=64, max_degree=3)
    X_const = (0.5 + 1e-4 * rng.standard_normal((256, 3))).astype(np.float32)
    X_deep = synthetic.random_cube(m=256, n=3, seed=1)
    bat = class_batch.fit_classes([X_const, X_deep], cfg, device="cpu")
    assert bat[0].stats["termination"] == "empty_border"
    assert bat[0].stats["degrees"] == [1]
    assert bat[1].stats["termination"] == "max_degree=3"
    assert bat[1].stats["degrees"] == [1, 2, 3]
    for X, b in zip([X_const, X_deep], bat):
        _assert_bit_exact(oavi.fit(X, cfg, device="cpu"), b)


@pytest.mark.parametrize("name", ["fast", "bpcg-ihb"])
def test_single_class_equals_sequential(name):
    """k = 1 runs alone (no discarded copy: the port's lanes are bit-stable)
    and equals the sequential fit when m is its bucket."""
    X = _classes(k=1, m=256, seed=4)[0]
    cfg = _config(name)
    (b,) = class_batch.fit_classes([X], cfg, device="cpu")
    assert b.stats["class_batch"]["size"] == 1
    _assert_bit_exact(oavi.fit(X, cfg, device="cpu"), b)


def test_shared_capacity_regrowth():
    """A class whose border overflows the shared Lcap regrows it for the
    whole group; the others keep their bits."""
    Xs = _classes(k=3, m=256, n=6, seed=30)
    cfg = OAVIConfig(psi=1e-4, engine="fast", cap_terms=8, cap_border=8)
    bat = class_batch.fit_classes(Xs, cfg, device="cpu")
    assert bat[0].stats["regrowths"] >= 1
    assert len({m.stats["Lcap_final"] for m in bat}) == 1
    for s, b in zip(_seq(Xs, cfg), bat):
        _assert_bit_exact(s, b)


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------


def _assert_close_to_reference(port, ref, X, tol=None):
    """Equal structure; coefficients at ``tol``, or (``None``: the inverse
    engine) no further from the float64 witness than 2x the reference."""
    _assert_structure(port, ref)
    if tol is None:
        witness = _lstsq_coeffs(ref, X)
        assert _witness_err(port, witness) <= 2.0 * _witness_err(ref, witness) + 1e-6
        return
    for gp, gr in zip(port.generators, ref.generators):
        np.testing.assert_allclose(gp.coeffs, gr.coeffs, **tol)


def test_fast_matches_reference_batched():
    """The fast engine against the reference's own class-batched fit, at
    equal and at uneven sizes."""
    for Xs in (_classes(k=3, m=256, seed=21),
               [np.clip(synthetic._planted_class(np.random.default_rng(7 + i), m, 4), 0, 1)
                .astype(np.float32) for i, m in enumerate([300, 500, 1003])]):
        port = class_batch.fit_classes(Xs, CFG, device="cpu")
        ref = j_cb.fit_classes(Xs, JConfig(psi=PSI, engine="fast", cap_terms=64))
        for X, p, r in zip(Xs, port, ref):
            _assert_close_to_reference(p, r, X)
            assert p.stats["class_batch"]["m_cap"] == r.stats["class_batch"]["m_cap"]


@pytest.mark.parametrize("name", [n for n in ENGINES if n != "fast"])
def test_engines_match_reference_sequential(name):
    """The oracle and WIHB engines, batched in the port, against the
    reference's sequential fits of the same config."""
    Xs, _, bat = _engine_fits(name)
    jcfg = _config(name, package="jax")
    for X, p in zip(Xs, bat):
        r = j_oavi.fit(X, jcfg)
        _assert_structure(p, r)
        if jcfg.solver.name in ("bpcg", "pcg") or jcfg.wihb:
            assert float(p.mse(X).max()) <= PSI * VANISH
        else:
            _assert_close_to_reference(p, r, X, None if jcfg.ihb else SAME_STEPS_TOL)


# ---------------------------------------------------------------------------
# The API and the classifier
# ---------------------------------------------------------------------------


def test_api_routes_and_padding_stats():
    """``api.fit(list)`` batches by default; the [256, 250, 17] plan is one
    padded group; the reference plans the same group and pads the same rows."""
    sizes = [256, 250, 17]
    Xs = [np.clip(synthetic._planted_class(np.random.default_rng(i), m, 4), 0, 1)
          .astype(np.float32) for i, m in enumerate(sizes)]
    models = api.fit(Xs, "oavi:fast", psi=PSI, device="cpu")
    ref = japi.fit_classes(Xs, "oavi:fast", psi=PSI)
    for X, m, r in zip(Xs, models, ref):
        assert m.stats["api"]["class_batch"] is True and m.stats["m"] == X.shape[0]
        assert m.stats["class_batch_padding"] == r.stats["class_batch_padding"]
        _assert_close_to_reference(m, r, X)
    agg = api.aggregate_fit_stats(models)
    jagg = japi.aggregate_fit_stats(ref)
    assert set(agg) == (set(jagg) - {"recompiles"}) | {"kernel_launches"}
    for key in ("regrowths", "class_batched", "class_batch_groups", "solver_schedule_len",
                "solver_escalations", "class_batch_padding"):
        assert agg[key] == jagg[key], key
    assert agg["class_batched"] == 3 and agg["class_batch_groups"] == 1


def test_api_sequential_routes():
    """``class_batch="off"``, a single class, ABM, VCA and the Cholesky engine
    fit one class after another (no group stats); ``chunk_rows`` streams the
    classes to the in-memory bits; the sharded backend without a process
    group is a world of one, the local batched fit's bits."""
    Xs = _classes(k=2, m=128, seed=3)
    auto = api.fit_classes(Xs, "oavi:fast", psi=PSI, device="cpu")
    off = api.fit_classes(Xs, "oavi:fast", psi=PSI, class_batch="off", device="cpu")
    assert all(m.stats.get("class_batch") for m in auto)
    assert all(m.stats.get("class_batch") is None for m in off)
    for a, b in zip(auto, off):
        _assert_bit_exact(a, b)
    single = api.fit_classes(Xs[:1], "oavi:fast", psi=PSI, device="cpu")
    assert single[0].stats.get("class_batch") is None
    for spec, kw in (("abm", dict(cap_terms=64)), ("vca", {}),
                     ("oavi:fast", dict(inverse_engine="chol"))):
        models = api.fit_classes(Xs, spec, psi=PSI, device="cpu", **kw)
        assert all(m.stats.get("class_batch") is None for m in models), spec
    with pytest.raises(ValueError, match="class_batch"):
        api.fit_classes(Xs, "oavi:fast", class_batch="always", device="cpu")
    streamed = api.fit_classes(Xs, "oavi:fast", psi=PSI, chunk_rows=1024, device="cpu")
    assert all(m.stats["class_batch"]["streaming"] for m in streamed)
    for s, b in zip(streamed, off):
        _assert_bit_exact(s, b)
    # the sharded backend without a process group: a world of one, the
    # local batched fit's bits
    sharded = api.fit_classes(Xs, "oavi:fast", psi=PSI, backend="sharded", device="cpu")
    assert all(m.stats["api"]["backend"] == "sharded" for m in sharded)
    for s, a in zip(sharded, auto):
        _assert_bit_exact(s, a)


@pytest.fixture(scope="module")
def seeds_data():
    X, y = synthetic.uci_like("seeds", seed=0)
    return synthetic.train_test_split(X, y)


@pytest.fixture(scope="module")
def seeds_classifiers(seeds_data):
    Xtr, ytr = seeds_data[0], seeds_data[1]
    on = VanishingIdealClassifier(PipelineConfig(method="fast", psi=PSI),
                                  device="cpu").fit(Xtr, ytr)
    off = VanishingIdealClassifier(PipelineConfig(method="fast", psi=PSI, class_batch="off"),
                                   device="cpu").fit(Xtr, ytr)
    ref = JClassifier(JPipeConfig(method="fast", psi=PSI, class_batch="auto")).fit(Xtr, ytr)
    return on, off, ref


def test_classifier_auto_equals_off(seeds_classifiers, seeds_data):
    """uci_like("seeds") (3 classes): the default "auto" classifier's models
    are the "off" classifier's bit for bit, and it predicts the same."""
    on, off, _ = seeds_classifiers
    Xte = seeds_data[2]
    assert on.config.class_batch == "auto"
    assert on.stats["class_batched"] == len(on.models) == 3
    assert off.stats["class_batched"] == 0
    assert "class_batch_padding" in on.stats
    for a, b in zip(on.models, off.models):
        _assert_bit_exact(a, b)
    assert np.array_equal(on.predict(Xte), off.predict(Xte))


def test_classifier_auto_matches_reference(seeds_classifiers, seeds_data):
    on, _, ref = seeds_classifiers
    Xte = seeds_data[2]
    assert ref.stats["class_batched"] == on.stats["class_batched"]
    for m, r in zip(on.models, ref.models):
        _assert_structure(m, r)
    np.testing.assert_allclose(on.transform(Xte), ref.transform(Xte), **INV_TOL)


def test_classifier_save_load_keeps_class_batch(tmp_path, seeds_classifiers, seeds_data):
    """The meta records the configuration's class_batch and loading reads it
    back, in the port and across both packages; labels survive each trip."""
    on, off, ref = seeds_classifiers
    Xte = seeds_data[2]
    for clf in (on, off):
        path = str(tmp_path / clf.config.class_batch)
        clf.save(path)
        again = VanishingIdealClassifier.load(path, device="cpu")
        assert again.config == clf.config
        assert np.array_equal(again.predict(Xte), clf.predict(Xte))
        jagain = JClassifier.load(path)
        assert jagain.config.class_batch == clf.config.class_batch
    path = str(tmp_path / "ref")
    ref.save(path)
    port = VanishingIdealClassifier.load(path, device="cpu")
    assert port.config.class_batch == "auto"
    feats = ref.transform(Xte)
    np.testing.assert_allclose(port.transform(Xte), feats, rtol=1e-6, atol=1e-6)
    scores = ref.svm.decision_function(feats)
    top2 = np.sort(scores, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 1e-4
    assert np.array_equal(port.predict(Xte)[clear], ref.predict(Xte)[clear])
    meta = dataclasses.asdict(port.config)
    assert meta["class_batch"] == "auto"
