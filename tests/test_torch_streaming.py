"""The port's out-of-core OAVI (``repro_torch.streaming``) on the CPU.

Against the JAX package (``repro.streaming``), with the same seeded inputs
fed to both, at the reference tests' sizes (M = 3000, n = 3,
``cap_terms=64``):

* sources, tiles and shard directories bit for bit (a directory written by
  either package reads in the other);
* the streaming scaler bit for bit in every dtype;
* the streamed fit's structure equal to ``repro.streaming.fit``'s, with
  coefficients allclose at rtol 5e-3, atol 2e-3: the tolerance
  ``tests/test_torch_oavi.py`` uses for the in-memory fit with the Theorem
  4.9 inverse, whose fp32 update amplifies the matvecs' summation order
  (PyTorch's CPU BLAS against XLA) by kappa(A)^2 even where both packages'
  Gram statistics agree.

Inside the port, bit for bit: the streamed fit equals the in-memory fit for
chunks {256, 1024, 4096} with ``fast`` and with an oracle engine, with
regrowth and with prefetch on or off; the class-batched streamed fit equals
each class's own streamed fit.
"""

import json
import os

import numpy as np
import pytest

from repro import api as japi
from repro import streaming as jstreaming
from repro.core.oavi import OAVIConfig as JConfig
from repro.core.oracles import OracleConfig as JOracle
from repro.data import synthetic as j_synth
from repro_torch import api, streaming
from repro_torch.core import oavi
from repro_torch.core.oavi import OAVIConfig
from repro_torch.core.oracles import OracleConfig
from repro_torch.core.transform import MinMaxScaler
from repro_torch.data import synthetic
from repro_torch.kernels import ops
from repro_torch.resilience.integrity import IntegrityError, flip_bit
from repro_torch.streaming import (
    ArraySource,
    ScaledSource,
    ShardDirSource,
    StreamingMinMaxScaler,
    iter_chunks,
)

M = 3000
PSI = 0.005
# the in-memory parity tolerance of tests/test_torch_oavi.py (inverse engine)
INV_TOL = dict(rtol=5e-3, atol=2e-3)

CONFIGS = {
    "fast": dict(engine="fast"),
    "cgavi-ihb": dict(engine="oracle", solver="cg", ihb=True),
    "bpcg-ihb": dict(engine="oracle", solver="bpcg", ihb=True),
}


def _config(name, package="port", **kw):
    spec = dict(CONFIGS[name])
    solver = spec.pop("solver", "bpcg")
    kw = {"psi": PSI, "ordering": "none", "cap_terms": 64, **spec, **kw}
    if package == "port":
        return OAVIConfig(solver=OracleConfig(name=solver), **kw)
    return JConfig(solver=JOracle(name=solver), **kw)


@pytest.fixture(scope="module")
def planted():
    """The raw planted stream, its materialization and a fitted scaler."""
    source = synthetic.planted_source(M, n=3, seed=0)
    X_raw = np.asarray(source.read(0, M))
    scaler = StreamingMinMaxScaler(dtype="float32").fit_source(source, 1024)
    return source, X_raw, scaler, scaler.transform(X_raw)


def _assert_bit_equal(a, b):
    assert a.book.terms == b.book.terms
    assert [g.term for g in a.generators] == [g.term for g in b.generators]
    for ga, gb in zip(a.generators, b.generators):
        assert np.array_equal(ga.coeffs, gb.coeffs), ga.term
        assert ga.mse == gb.mse, ga.term


def _assert_close_to_reference(port, ref):
    assert port.book.terms == ref.book.terms
    assert [g.term for g in port.generators] == [g.term for g in ref.generators]
    for gp, gr in zip(port.generators, ref.generators):
        np.testing.assert_allclose(gp.coeffs, gr.coeffs, **INV_TOL)


# ---------------------------------------------------------------------------
# sources, tiles, shards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tile,n,seed", [(0, 3, 0), (7, 3, 11), (2, 5, 3)])
def test_planted_tiles_identical(tile, n, seed):
    got = synthetic.planted_stream_tile(tile, n=n, seed=seed)
    assert np.array_equal(got, j_synth.planted_stream_tile(tile, n=n, seed=seed))
    assert got.shape == (synthetic.STREAM_TILE_ROWS, n)
    assert not np.array_equal(got, synthetic.planted_stream_tile(tile + 1, n=n, seed=seed))


def test_planted_source_identical_and_chunking_invariant():
    src = synthetic.planted_source(10_000, n=3, seed=3)
    ref = j_synth.planted_source(10_000, n=3, seed=3)
    whole = src.read(0, 10_000)
    assert np.array_equal(whole, ref.read(0, 10_000))
    for rows in (256, 1024, 4096):
        port = list(iter_chunks(src, rows))
        jax_ = list(jstreaming.iter_chunks(ref, rows))
        assert [v for _, v in port] == [v for _, v in jax_]
        for (a, _), (b, _) in zip(port, jax_):
            assert np.array_equal(a, b)
        assert np.array_equal(np.concatenate([c[:v] for c, v in port]), whole)
    assert np.array_equal(src.read(5000, 7000), whole[5000:7000])


def test_iter_chunks_pads_trailing_chunk():
    src = ArraySource(np.arange(10.0).reshape(5, 2))
    chunks = list(iter_chunks(src, 4))
    assert [c.shape for c, _ in chunks] == [(4, 2), (4, 2)]
    assert [v for _, v in chunks] == [4, 1]
    assert np.array_equal(chunks[1][0][1:], np.zeros((3, 2)))
    assert streaming.is_source(src) and not streaming.is_source(np.zeros(3))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_shard_dirs_cross_packages(tmp_path, planted, writer):
    source, X_raw, _, _ = planted
    path = str(tmp_path / "shards")
    write = synthetic.write_shards if writer == "port" else j_synth.write_shards
    meta = write(path, source, shard_rows=1024)
    assert meta["num_shards"] == (M + 1023) // 1024
    other = str(tmp_path / "other")
    (j_synth.write_shards if writer == "port" else synthetic.write_shards)(
        other, source, shard_rows=1024)
    with open(os.path.join(path, "meta.json")) as f, \
            open(os.path.join(other, "meta.json")) as g:
        assert json.load(f) == json.load(g)  # checksums and byte counts too
    for sd in (ShardDirSource(path), jstreaming.ShardDirSource(path)):
        assert (sd.num_rows, sd.num_features) == (M, 3)
        assert np.array_equal(sd.read(0, M), X_raw.astype(np.float32))
        assert np.array_equal(sd.read(1000, 2100), X_raw[1000:2100].astype(np.float32))
    assert ShardDirSource(path).verify_all() == meta["num_shards"]


def test_shard_dir_rejects_wrong_format_and_corruption(tmp_path):
    (tmp_path / "bad").mkdir()
    (tmp_path / "bad" / "meta.json").write_text(json.dumps({"format": "other"}))
    with pytest.raises(ValueError, match="repro.shards.v1"):
        ShardDirSource(str(tmp_path / "bad"))
    path = str(tmp_path / "shards")
    synthetic.write_shards(path, synthetic.random_cube(1024, 3, seed=0), shard_rows=512)
    flip_bit(os.path.join(path, "shard_00001.npy"), byte_offset=200)
    src = ShardDirSource(path)
    assert src.read(0, 512).shape == (512, 3)  # shard 0 verifies
    with pytest.raises(IntegrityError, match="shard_00001"):
        src.read(500, 600)


# ---------------------------------------------------------------------------
# streaming scaler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16", "float64"])
def test_streaming_scaler_bit_exact_every_dtype(planted, dtype):
    """lo/scale and the transformed rows equal the in-memory scaler's and
    the reference streaming scaler's bit for bit, in every dtype."""
    source, X_raw, _, _ = planted
    ref = MinMaxScaler(dtype=dtype).fit(X_raw)
    for rows in (256, 1024, 4096):
        sc = StreamingMinMaxScaler(dtype=dtype).fit_source(source, rows)
        jsc = jstreaming.StreamingMinMaxScaler(dtype=dtype).fit_source(
            j_synth.planted_source(M, n=3, seed=0), rows)
        for a, b in ((sc.lo, ref.lo), (sc.scale, ref.scale), (sc.hi, jsc.hi),
                     (sc.lo, jsc.lo), (sc.scale, jsc.scale)):
            assert np.array_equal(a, b)
        out = sc.transform(X_raw[:500])
        for want in (ref.transform(X_raw[:500]), jsc.transform(X_raw[:500])):
            assert out.dtype == want.dtype
            assert np.array_equal(out, want)


def test_streaming_scaler_partial_fit_prefix_usable():
    X = np.random.default_rng(0).uniform(-3, 5, (100, 4))
    sc = StreamingMinMaxScaler()
    sc.partial_fit(X[:40])
    assert sc.scale is not None  # usable mid-stream
    sc.partial_fit(X[40:])
    ref = MinMaxScaler().fit(X)
    assert np.array_equal(sc.lo, ref.lo) and np.array_equal(sc.scale, ref.scale)
    with pytest.raises(ValueError, match="fitted"):
        ScaledSource(ArraySource(X), StreamingMinMaxScaler())
    with pytest.raises(ValueError, match="empty"):
        StreamingMinMaxScaler().fit_source(ArraySource(np.zeros((0, 4))))


# ---------------------------------------------------------------------------
# the streamed fit: inside the port bit for bit, against the reference
# ---------------------------------------------------------------------------

_FITS = {}


def _in_memory(X, name, **kw):
    key = (name, tuple(sorted(kw.items())))
    if key not in _FITS:
        _FITS[key] = oavi.fit(X, _config(name, **kw), device="cpu")
    return _FITS[key]


@pytest.mark.parametrize("chunk_rows", [256, 1024, 4096])
@pytest.mark.parametrize("name", ["fast", "cgavi-ihb"])
def test_streamed_fit_equals_in_memory(planted, name, chunk_rows):
    source, _, scaler, X = planted
    model = streaming.fit(ScaledSource(source, scaler), _config(name), chunk_rows=chunk_rows,
                          device="cpu")
    _assert_bit_equal(model, _in_memory(X, name))
    st = model.stats["streaming"]
    assert st["chunk_rows"] == chunk_rows
    assert st["passes"] == len(model.stats["degrees"])
    assert st["num_chunks"] == st["passes"] * -(-M // chunk_rows)
    assert model.stats["kernel_launches"]["gram_update_acc"] == 0  # the CPU's plain path


def test_streamed_fit_regrowth_equals_in_memory(planted):
    """A tiny initial capacity makes both paths regrow."""
    source, _, scaler, X = planted
    kw = dict(psi=0.0005, cap_terms=8, max_degree=3)
    model = streaming.fit(ScaledSource(source, scaler), _config("fast", **kw),
                          chunk_rows=512, device="cpu")
    ref = _in_memory(X, "fast", **kw)
    assert model.stats["regrowths"] == ref.stats["regrowths"] > 0
    assert model.stats["Lcap_final"] == ref.stats["Lcap_final"]
    _assert_bit_equal(model, ref)


def test_streamed_fit_prefetch_on_equals_off(planted):
    source, _, scaler, _ = planted
    cfg = _config("fast", ordering="pearson")
    on = streaming.fit(ScaledSource(source, scaler), cfg, chunk_rows=256, device="cpu")
    off = streaming.fit(ScaledSource(source, scaler), cfg, chunk_rows=256, prefetch=False,
                        device="cpu")
    _assert_bit_equal(on, off)


def test_streamed_pearson_ordering_matches(planted):
    """The one-pass moment order is the in-memory order on this data (the
    reference's contract: they may differ only at near-exact score ties),
    and then the fit is bit-exact; the reference's streamed order agrees."""
    source, _, scaler, X = planted
    cfg = _config("fast", ordering="pearson")
    model = streaming.fit(ScaledSource(source, scaler), cfg, chunk_rows=1024, device="cpu")
    ref = oavi.fit(X, cfg, device="cpu")
    assert np.array_equal(model.feature_perm, ref.feature_perm)
    _assert_bit_equal(model, ref)
    jperm = jstreaming.streaming_pearson_order(
        jstreaming.ScaledSource(j_synth.planted_source(M, n=3, seed=0), scaler), 1024)
    assert np.array_equal(model.feature_perm, jperm)
    s1, s2 = streaming.pearson_moments(ScaledSource(source, scaler), 1024)
    js1, js2 = jstreaming.pearson_moments(ScaledSource(source, scaler), 1024)
    assert np.array_equal(s1, js1) and np.array_equal(s2, js2)


@pytest.mark.parametrize("name", ["fast", "cgavi-ihb"])
def test_streamed_fit_matches_reference(planted, name):
    """Structure equal to ``repro.streaming.fit``; coefficients at INV_TOL."""
    source, _, scaler, _ = planted
    port = streaming.fit(ScaledSource(source, scaler), _config(name), chunk_rows=1024,
                         device="cpu")
    ref = jstreaming.fit(jstreaming.ScaledSource(j_synth.planted_source(M, n=3, seed=0),
                                                 scaler), _config(name, "jax"), chunk_rows=1024)
    _assert_close_to_reference(port, ref)
    for key in ("degrees", "border_sizes", "regrowths", "termination"):
        assert port.stats[key] == ref.stats[key], key
    assert port.stats["streaming"] == ref.stats["streaming"]


@pytest.mark.parametrize("bad", [100, 128, 384])
def test_streamed_fit_rejects_bad_chunk_rows(planted, bad):
    source, _, scaler, _ = planted
    with pytest.raises(ValueError, match="chunk_rows"):
        streaming.fit(ScaledSource(source, scaler), OAVIConfig(), chunk_rows=bad,
                      device="cpu")


def test_streamed_fit_rejections(planted):
    source, _, scaler, _ = planted
    # a mesh must carry the data axes the fit splits the rows over
    no_data_axis = type("Mesh", (), {"mesh_dim_names": ("model",)})()
    with pytest.raises(ValueError, match="data_axes"):
        streaming.fit(ScaledSource(source, scaler), OAVIConfig(), mesh=no_data_axis,
                      device="cpu")
    with pytest.raises(ValueError, match="GRAM_BLOCK|Gram block"):
        streaming.accumulate_source_range(None, source, 100, 200, 256, (None, None),
                                          None, None)


def test_chunked_gram_equals_one_shot_at_streaming_shapes():
    """The carry-in contract on the CPU's plain path at a streamed degree's
    shapes (L = K = 64, n = 3): chunks of 256 to 4096 rows fold to the bits
    of one call."""
    rng = np.random.default_rng(0)
    import torch

    m, L, n, K = 8192, 64, 3, 64
    A = torch.from_numpy(rng.uniform(0, 1, (m, L)).astype(np.float32))
    X = torch.from_numpy(rng.uniform(0, 1, (m, n)).astype(np.float32))
    p = torch.from_numpy(rng.integers(0, L, K))
    v = torch.from_numpy(rng.integers(0, n, K))
    one = ops.gram_accumulate(A, X, p, v)
    for rows in (256, 1024, 4096):
        acc = (torch.zeros(L, K), torch.zeros(K, K))
        for lo in range(0, m, rows):
            acc = ops.gram_accumulate(A[lo:lo + rows], X[lo:lo + rows], p, v, acc=acc)
        assert all(torch.equal(a, b) for a, b in zip(acc, one))


# ---------------------------------------------------------------------------
# the class-batched streamed fit
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def three_classes():
    sizes = [1500, 900, 1200]
    sources = [synthetic.planted_source(m, n=3, seed=40 + i) for i, m in enumerate(sizes)]
    scalers = [StreamingMinMaxScaler(dtype="float32").fit_source(s, 512) for s in sources]
    scaled = [ScaledSource(s, sc) for s, sc in zip(sources, scalers)]
    Xs = [np.asarray(s.read(0, s.num_rows)) for s in scaled]
    return scaled, Xs


@pytest.mark.parametrize("name", ["fast", "bpcg-ihb"])
def test_streamed_fit_classes_equal_per_class_fits(three_classes, name):
    """Each class equals its own streamed fit and its in-memory fit bit for
    bit; the reference's streamed class batch gives the same structure."""
    scaled, Xs = three_classes
    cfg = _config(name)
    models = streaming.fit_classes(scaled, cfg, chunk_rows=512, device="cpu")
    ref = jstreaming.fit_classes(Xs, _config(name, "jax"), chunk_rows=512)
    for src, X, model, r in zip(scaled, Xs, models, ref):
        _assert_bit_equal(model, streaming.fit(src, cfg, chunk_rows=512, device="cpu"))
        _assert_bit_equal(model, oavi.fit(X, cfg, device="cpu"))
        assert model.book.terms == r.book.terms
        assert [g.term for g in model.generators] == [g.term for g in r.generators]
        assert model.stats["class_batch"]["streaming"] is True
        assert model.stats["class_batch"]["m_cap"] is None
        assert model.stats["streaming"]["passes"] == len(model.stats["degrees"])
    assert len({m.stats["class_batch"]["group"] for m in models}) == 1
    lone = streaming.fit_classes(scaled[:1], cfg, chunk_rows=512, device="cpu")
    _assert_bit_equal(lone[0], models[0])
    assert streaming.fit_classes([], cfg, device="cpu") == []
    with pytest.raises(ValueError, match="class-batchable"):
        streaming.fit_classes(scaled, _config("fast", inverse_engine="chol"), device="cpu")


# ---------------------------------------------------------------------------
# the API and the classifier
# ---------------------------------------------------------------------------


def test_api_fit_source_dispatch(planted):
    source, _, scaler, X = planted
    kw = dict(psi=PSI, ordering="none", cap_terms=64, device="cpu")
    ref = api.fit(X, "oavi:fast", backend="local", **kw)
    model = api.fit(ScaledSource(source, scaler), "oavi:fast", chunk_rows=1024, **kw)
    assert model.stats["api"]["streaming"] is True
    _assert_bit_equal(model, ref)
    _assert_bit_equal(api.fit(None, "oavi:fast", source=ScaledSource(source, scaler),
                              chunk_rows=1024, **kw), ref)
    # chunk_rows on an array streams through it
    through = api.fit(X, "oavi:fast", chunk_rows=256, **kw)
    assert through.stats["streaming"]["chunk_rows"] == 256
    _assert_bit_equal(through, ref)


def test_api_fit_source_rejections(planted):
    source, _, scaler, X = planted
    with pytest.raises(ValueError, match="OAVI only"):
        api.fit(ScaledSource(source, scaler), "vca", device="cpu")
    with pytest.raises(ValueError, match="local-only"):
        api.fit(X, "oavi", chunk_rows=1024, backend="sharded", capture_state=True,
                device="cpu")
    # the sharded streamed fit without a process group: a world of one
    sharded = api.fit(X, "oavi", chunk_rows=1024, backend="sharded", device="cpu")
    assert sharded.stats["api"]["backend"] == "sharded"
    _assert_bit_equal(sharded, api.fit(X, "oavi", chunk_rows=1024, device="cpu"))


def test_api_fit_classes_streaming_route():
    rng = np.random.default_rng(3)
    Xs = [rng.uniform(0, 1, (m, 3)).astype(np.float32) for m in (700, 500)]
    models = api.fit_classes(Xs, "oavi:fast", psi=PSI, cap_terms=64, chunk_rows=256,
                             device="cpu")
    ref = japi.fit_classes(Xs, "oavi:fast", psi=PSI, cap_terms=64, chunk_rows=256)
    for X, model, r in zip(Xs, models, ref):
        assert model.stats["api"]["streaming"] and model.stats["api"]["class_batch"]
        _assert_bit_equal(model, api.fit(X, "oavi:fast", psi=PSI, cap_terms=64,
                                         device="cpu"))
        assert model.book.terms == r.book.terms
    # the Cholesky engine streams one class after another
    chol = api.fit_classes(Xs, "oavi:fast", psi=PSI, cap_terms=64, chunk_rows=256,
                           inverse_engine="chol", device="cpu")
    assert all(m.stats["api"]["streaming"] and "class_batch" not in m.stats["api"]
               for m in chol)


def test_classifier_chunk_rows_bit_identical(appc_small):
    """``PipelineConfig(chunk_rows=...)`` streams the per-class fits and gives
    the in-memory classifier's models and labels."""
    from repro_torch.core.pipeline import PipelineConfig, VanishingIdealClassifier

    Xtr, ytr, Xte, _ = appc_small
    kw = dict(method="fast", psi=0.01, oavi_kw={"cap_terms": 64, "ordering": "none"})
    ref = VanishingIdealClassifier(PipelineConfig(class_batch="off", **kw), device="cpu")
    ref.fit(Xtr, ytr)
    clf = VanishingIdealClassifier(PipelineConfig(chunk_rows=512, **kw), device="cpu")
    clf.fit(Xtr, ytr)
    for a, b in zip(clf.models, ref.models):
        assert a.stats["api"]["streaming"] is True
        _assert_bit_equal(a, b)
    assert np.array_equal(clf.predict(Xte), ref.predict(Xte))


def test_classifier_chunk_rows_save_load_both_packages(appc_small, tmp_path):
    from repro.core.pipeline import VanishingIdealClassifier as JClassifier
    from repro_torch.core.pipeline import PipelineConfig, VanishingIdealClassifier

    Xtr, ytr, Xte, _ = appc_small
    clf = VanishingIdealClassifier(
        PipelineConfig(method="fast", psi=0.01, chunk_rows=512, oavi_kw={"cap_terms": 64}),
        device="cpu")
    clf.fit(Xtr, ytr)
    path = str(tmp_path / "clf")
    clf.save(path)
    loaded = VanishingIdealClassifier.load(path, device="cpu")
    assert loaded.config.chunk_rows == 512 and loaded.config.capture_fit_state is False
    assert np.array_equal(loaded.predict(Xte), clf.predict(Xte))
    assert JClassifier.load(path).config.chunk_rows == 512
