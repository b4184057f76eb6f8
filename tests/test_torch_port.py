"""The port as a package: no JAX, the device rule, and its numpy-only copies.

* ``repro_torch`` and every module of the slice import with ``jax`` blocked
  and load no module of the JAX package ``repro``.
* Entry points default to the CUDA card and raise without one; the CPU runs
  only when asked for.
* The copied host modules (term book, DegLex borders, Pearson ordering,
  min-max scaling, dataset generators) give exactly what the originals give.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.core import ordering as j_ordering
from repro.core import terms as j_terms
from repro.core.transform import MinMaxScaler as JScaler
from repro.data import synthetic as j_synth
from repro_torch import api
from repro_torch.core import ordering, terms
from repro_torch.core.pipeline import PipelineConfig, VanishingIdealClassifier
from repro_torch.core.transform import MinMaxScaler
from repro_torch.data import synthetic

SLICE_MODULES = [
    "repro_torch",
    "repro_torch._device",
    "repro_torch.api",
    "repro_torch.checkpoint",
    "repro_torch.checkpoint.store",
    "repro_torch.configs",
    "repro_torch.configs.deepseek_v2_lite_16b",
    "repro_torch.configs.hubert_xlarge",
    "repro_torch.configs.jamba_1_5_large_398b",
    "repro_torch.configs.kimi_k2_1t_a32b",
    "repro_torch.configs.oavi_paper",
    "repro_torch.configs.phi4_mini_3_8b",
    "repro_torch.configs.qwen1_5_4b",
    "repro_torch.configs.qwen2_1_5b",
    "repro_torch.configs.qwen2_vl_2b",
    "repro_torch.configs.qwen3_8b",
    "repro_torch.configs.shapes",
    "repro_torch.configs.xlstm_1_3b",
    "repro_torch.convert",
    "repro_torch.core",
    "repro_torch.core.abm",
    "repro_torch.core.class_batch",
    "repro_torch.core.distributed",
    "repro_torch.core.ihb",
    "repro_torch.core.oavi",
    "repro_torch.core.oracles",
    "repro_torch.core.ordering",
    "repro_torch.core.pipeline",
    "repro_torch.core.svm",
    "repro_torch.core.terms",
    "repro_torch.core.transform",
    "repro_torch.core.vca",
    "repro_torch.data",
    "repro_torch.data.lm",
    "repro_torch.data.synthetic",
    "repro_torch.kernels",
    "repro_torch.kernels._build",
    "repro_torch.kernels.flash_attention",
    "repro_torch.kernels.gram_update",
    "repro_torch.kernels.ihb_update",
    "repro_torch.kernels.ops",
    "repro_torch.kernels.ref",
    "repro_torch.launch",
    "repro_torch.launch.chaos_vi",
    "repro_torch.launch.continuous_vi",
    "repro_torch.launch.dryrun",
    "repro_torch.launch.hlo_analysis",
    "repro_torch.launch.mesh",
    "repro_torch.launch.obs_report",
    "repro_torch.launch.serve",
    "repro_torch.launch.serve_vi",
    "repro_torch.launch.train",
    "repro_torch.models",
    "repro_torch.models.attention",
    "repro_torch.models.hints",
    "repro_torch.models.layers",
    "repro_torch.models.mla",
    "repro_torch.models.model",
    "repro_torch.models.moe",
    "repro_torch.models.ssm",
    "repro_torch.obs",
    "repro_torch.obs.baseline",
    "repro_torch.obs.core",
    "repro_torch.obs.device",
    "repro_torch.obs.metrics",
    "repro_torch.obs.slo",
    "repro_torch.obs.trace",
    "repro_torch.online",
    "repro_torch.online.drift",
    "repro_torch.online.state",
    "repro_torch.online.update",
    "repro_torch.optim",
    "repro_torch.optim.adamw",
    "repro_torch.resilience",
    "repro_torch.resilience.chaos",
    "repro_torch.resilience.integrity",
    "repro_torch.resilience.journal",
    "repro_torch.runtime",
    "repro_torch.runtime.data_parallel",
    "repro_torch.runtime.fault_tolerance",
    "repro_torch.runtime.tensor_parallel",
    "repro_torch.serving",
    "repro_torch.serving.batcher",
    "repro_torch.serving.engine",
    "repro_torch.serving.registry",
    "repro_torch.streaming",
    "repro_torch.streaming.fit",
    "repro_torch.streaming.scaler",
    "repro_torch.streaming.source",
]


def test_port_imports_without_jax_or_repro():
    code = textwrap.dedent(f"""
        import importlib, sys
        sys.modules["jax"] = None  # any import of jax now raises
        for name in {SLICE_MODULES!r}:
            importlib.import_module(name)
        loaded = sorted(m for m in sys.modules
                        if m == "repro" or m.startswith("repro."))
        assert not loaded, loaded
        assert sys.modules["jax"] is None
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=os.path.abspath("src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("OK")


@pytest.fixture
def no_card(monkeypatch):
    """Make the process see no CUDA card, whatever machine runs the test."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_fit_without_device_raises_without_card(no_card):
    X = np.random.default_rng(0).uniform(0, 1, (100, 3))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.fit(X)
    with pytest.raises(RuntimeError):
        VanishingIdealClassifier(PipelineConfig())
    with pytest.raises(RuntimeError):
        api.fit(X, device="cuda")
    assert api.fit(X, device="cpu").num_O >= 1


@pytest.mark.parametrize("spec", ["abm", "vca"], ids=["abm-item 9", "vca-item 9"])
def test_unported_methods_raise(spec):
    """The baselines (ROADMAP item 9) fit through ``api.fit`` and give the
    reference's structure and ``|G(Z)|`` (rtol 1e-4, atol 1e-5: fp32 from
    two LAPACK builds; tests/test_torch_abm_vca.py holds more)."""
    from repro import api as japi

    X = np.random.default_rng(0).uniform(0, 1, (64, 3))
    model = api.fit(X, spec, device="cpu")
    ref = japi.fit(X, spec)
    assert model.stats["api"]["method"] == ref.stats["api"]["method"] == spec
    assert model.num_G == ref.num_G and model.stats["degrees"] == ref.stats["degrees"]
    np.testing.assert_allclose(model.transform(X), np.asarray(ref.transform(X)),
                               rtol=1e-4, atol=1e-5)


def test_unported_options_raise():
    """Every fit option is ported: the sharded backend (item 12a) runs as a
    world of one without a process group, the local fit's bits; out-of-core
    fits (item 11) stream, one class or a class-batched list, and equal the
    in-memory fits bit for bit."""
    X = np.random.default_rng(0).uniform(0, 1, (64, 3))
    sharded = api.fit(X, backend="sharded", device="cpu")
    assert sharded.stats["api"]["backend"] == "sharded"
    assert sharded.stats["all_reduces"] == 0  # no process group: no collective
    local = api.fit(X, backend="local", device="cpu")
    assert sharded.book.terms == local.book.terms
    assert all(np.array_equal(a.coeffs, b.coeffs)
               for a, b in zip(sharded.generators, local.generators))
    streamed = api.fit(X, chunk_rows=1024, device="cpu")
    in_memory = api.fit(X, device="cpu")
    assert streamed.stats["api"]["streaming"] is True
    assert streamed.book.terms == in_memory.book.terms
    assert all(np.array_equal(a.coeffs, b.coeffs)
               for a, b in zip(streamed.generators, in_memory.generators))
    models = api.fit([X, X], class_batch="auto", device="cpu")
    assert all(m.stats["api"]["class_batch"] is True for m in models)
    both = api.fit([X, X], class_batch="auto", chunk_rows=1024, device="cpu")
    assert all(m.stats["api"]["streaming"] and m.stats["class_batch"]["streaming"]
               for m in both)
    assert [m.book.terms for m in both] == [m.book.terms for m in models]


def test_resolve_matches_reference():
    from repro import api as japi

    for spec in ("oavi", "fast", "oavi:fast", "oavi:cgavi", "abm", "vca"):
        entry, variant = japi.resolve(spec)
        got, got_variant = api.resolve(spec)
        assert (got.name, got_variant) == (entry.name, variant)
        assert got.variants == entry.variants and got.spec(variant) == entry.spec(variant)
    assert api.available_methods() == japi.available_methods()
    with pytest.raises(ValueError):
        api.resolve("oavi:nope")


@pytest.mark.parametrize("n,d", [(2, 3), (3, 4), (5, 2)])
def test_terms_and_borders_identical(n, d):
    assert terms.all_terms_up_to_degree(n, d) == j_terms.all_terms_up_to_degree(n, d)
    book, jbook = terms.TermBook(n=n), j_terms.TermBook(n=n)
    rng = np.random.default_rng(n * 10 + d)
    for deg in range(1, d + 1):
        border, jborder = book.border(deg), jbook.border(deg)
        assert border == jborder
        for term, parent, j in border:  # append a random half to O
            if rng.uniform() < 0.5:
                book.append(term, parent, j)
                jbook.append(term, parent, j)
    assert book.terms == jbook.terms
    assert book.parents == jbook.parents and book.vars == jbook.vars
    assert terms.theorem_4_3_size_bound(0.005, n) == j_terms.theorem_4_3_size_bound(0.005, n)


@pytest.mark.parametrize("reverse", [False, True])
def test_pearson_orders_identical(reverse):
    X = np.random.default_rng(2).uniform(0, 1, (500, 7))
    X[:, 3] = X[:, 1] * 0.7 + 0.1 * X[:, 5]
    assert np.array_equal(ordering.pearson_order(X, reverse=reverse),
                          j_ordering.pearson_order(X, reverse=reverse))
    s1, s2 = X.sum(0), X.T @ X
    assert np.array_equal(
        ordering.pearson_order_from_moments(s1, s2, 500, reverse=reverse),
        j_ordering.pearson_order_from_moments(s1, s2, 500, reverse=reverse),
    )


def test_scaler_identical():
    X = np.random.default_rng(3).normal(0, 2, (300, 5))
    X[:, 2] = 1.5  # constant feature
    a = MinMaxScaler(dtype="float32").fit(X[:200])
    b = JScaler(dtype="float32").fit(X[:200])
    assert np.array_equal(a.transform(X), b.transform(X))


def test_synthetic_identical():
    for got, want in [
        (synthetic.appendix_c(m=2001, seed=3), j_synth.appendix_c(m=2001, seed=3)),
        (synthetic.uci_like("seeds", seed=1), j_synth.uci_like("seeds", seed=1)),
    ]:
        for g, w in zip(got, want):
            assert np.array_equal(g, w)
    assert np.array_equal(synthetic.random_cube(50, 4, seed=2),
                          j_synth.random_cube(50, 4, seed=2))
    X, y = synthetic.appendix_c(m=500, seed=0)
    for g, w in zip(synthetic.train_test_split(X, y, seed=1),
                    j_synth.train_test_split(X, y, seed=1)):
        assert np.array_equal(g, w)
