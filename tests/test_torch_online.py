"""The port's incremental OAVI (``repro_torch.online``) on the CPU.

Inside the port, bit for bit: an update equals a full streamed refit of the
grown source (fast and oracle engines, several chunk sizes, increments that
end off the Gram block and off the chunk grid), a chain of updates equals
one hop and hands on the same state, prefetch changes nothing, and the fold
and replay counts say which degrees read the old rows.  Against the JAX
package: a ``FitState`` saved by either package loads in the other and
updates to the same bits there, the updated model's structure is the
reference's, and the drift signals are the reference's.  The sizes are the
reference tests' (``tests/test_online.py``: 2,500 -> 3,211 -> 3,900 rows,
n = 3, ``cap_terms=64``).
"""

import numpy as np
import pytest

from repro import online as jonline
from repro import streaming as jstreaming
from repro.core.oavi import OAVIConfig as JConfig
from repro.data import synthetic as j_synth
from repro_torch import api, online, streaming
from repro_torch.core.oavi import OAVIConfig
from repro_torch.data.synthetic import planted_source, random_cube, write_shards
from repro_torch.online import DriftConfig, DriftMonitor, FitState
from repro_torch.streaming import ArraySource, ScaledSource, ShardDirSource
from repro_torch.streaming.fit import prefetch_map
from repro_torch.streaming.scaler import StreamingMinMaxScaler

M_BASE = 2500
M_MID = 3211  # a multiple of neither the Gram block nor chunk_rows
M_FULL = 3900
CFG = OAVIConfig(psi=0.005, engine="fast", ordering="pearson", cap_terms=64)
JCFG = JConfig(psi=0.005, engine="fast", ordering="pearson", cap_terms=64)
CPU = dict(device="cpu")


def _assert_bit_equal(a, b):
    assert a.book.terms == b.book.terms
    assert [g.term for g in a.generators] == [g.term for g in b.generators]
    for ga, gb in zip(a.generators, b.generators):
        assert np.array_equal(ga.coeffs, gb.coeffs), ga.term
        assert ga.mse == gb.mse


def _assert_states_equal(a, b):
    assert (a.num_rows, a.aligned_rows, a.chunk_rows, a.moment_rows) == (
        b.num_rows, b.aligned_rows, b.chunk_rows, b.moment_rows)
    assert np.array_equal(a.book_parents, b.book_parents)
    assert np.array_equal(a.book_vars, b.book_vars)
    assert len(a.records) == len(b.records)
    for ra, rb in zip(a.records, b.records):
        assert (ra.degree, ra.ell, ra.K, ra.Lcap, ra.Kcap) == (
            rb.degree, rb.ell, rb.K, rb.Lcap, rb.Kcap)
        assert np.array_equal(ra.accQL, rb.accQL)
        assert np.array_equal(ra.accC, rb.accC)
    for x, y in ((a.moments, b.moments), (a.feature_perm, b.feature_perm)):
        assert (x is None) == (y is None)
        if x is not None:
            assert all(np.array_equal(u, v) for u, v in zip(x, y)) if isinstance(
                x, tuple) else np.array_equal(x, y)


@pytest.fixture(scope="module")
def stream():
    """Prefix-consistent planted stream: the m-row source is the first m rows
    of the larger one, the grown-source contract of update().  Seed 3's
    feature order is stable from 2,500 to 3,900 rows."""
    scaler = StreamingMinMaxScaler(dtype="float32").fit_source(
        planted_source(M_FULL, n=3, seed=3), 1024)
    view = lambda m: ScaledSource(planted_source(m, n=3, seed=3), scaler)  # noqa: E731
    return view, scaler


# ---------------------------------------------------------------------------
# fold = refit, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk_rows", [256, 512, 1024, 2048])
def test_update_equals_refit(stream, chunk_rows):
    view, _ = stream
    model0, state0 = online.fit(view(M_BASE), CFG, chunk_rows=chunk_rows, **CPU)
    _assert_bit_equal(model0, streaming.fit(view(M_BASE), CFG, chunk_rows=chunk_rows, **CPU))
    res = online.update(model0, state0, view(M_FULL), **CPU)
    ref = streaming.fit(view(M_FULL), CFG, chunk_rows=chunk_rows, **CPU)
    _assert_bit_equal(res.model, ref)
    assert np.array_equal(res.model.feature_perm, ref.feature_perm)


@pytest.mark.parametrize("sizes", [(M_BASE, M_MID, M_FULL), (2304, 2560, 4097),
                                   (1000, 1001, 1279)])
def test_update_chain_equals_one_hop(stream, sizes):
    """update(update(S, a), b) == update(S, a ++ b) == a refit, and both hand
    the next update the same state, at growth sizes on and off the block."""
    view, _ = stream
    base, mid, full = sizes
    model0, state0 = online.fit(view(base), CFG, chunk_rows=512, **CPU)
    hop1 = online.update(model0, state0, view(mid), **CPU)
    chained = online.update(hop1.model, hop1.state, view(full), **CPU)
    one_hop = online.update(model0, state0, view(full), **CPU)
    ref_model, ref_state = online.fit(view(full), CFG, chunk_rows=512, **CPU)
    for res in (chained, one_hop):
        _assert_bit_equal(res.model, ref_model)
        _assert_states_equal(res.state, ref_state)


@pytest.mark.parametrize("solver,ihb", [("cg", True), ("bpcg", False)])
def test_update_equals_refit_oracle_engine(stream, solver, ihb):
    from repro_torch.core.oracles import OracleConfig

    view, _ = stream
    cfg = OAVIConfig(psi=0.005, engine="oracle", solver=OracleConfig(name=solver), ihb=ihb,
                     ordering="none", cap_terms=64)
    model0, state0 = online.fit(view(M_BASE), cfg, chunk_rows=512, **CPU)
    res = online.update(model0, state0, view(M_FULL), **CPU)
    _assert_bit_equal(res.model, streaming.fit(view(M_FULL), cfg, chunk_rows=512, **CPU))


def test_update_folds_unchanged_degrees(stream):
    """More of the same data: every degree folds, none replays, and the fold
    reads only the new rows."""
    view, _ = stream
    model0, state0 = online.fit(view(M_BASE), CFG, chunk_rows=512, **CPU)
    res = online.update(model0, state0, view(M_FULL), **CPU)
    assert res.stats["replayed_degrees"] == []
    assert res.stats["folded_degrees"] == len(state0.records) > 0
    assert res.stats["refit_reason"] is None
    # per degree: the chunks from the old aligned row to the new one, and
    # the tail's
    aligned = (M_FULL // 256) * 256
    per_degree = -(-(aligned - state0.aligned_rows) // 512) + (aligned < M_FULL)
    assert res.stats["chunks"] == per_degree * len(res.state.records)
    assert res.stats["chunks"] < -(-M_FULL // 512) * len(res.state.records)
    assert res.model.stats["online"]["base_rows"] == M_BASE


def test_update_replays_on_border_change():
    """New data that flips a verdict (x0 vanished on the base rows, varies on
    the new ones) replays only the degrees past the flip."""
    cfg = OAVIConfig(psi=0.005, engine="fast", ordering="none", cap_terms=64)
    rng = np.random.default_rng(0)
    base = rng.uniform(0, 1, (2560, 3)).astype(np.float32)
    base[:, 0] = 0.5 + rng.normal(0, 0.01, 2560).astype(np.float32)
    grown = np.concatenate([base, rng.uniform(0, 1, (1280, 3)).astype(np.float32)])
    model0, state0 = online.fit(ArraySource(base), cfg, chunk_rows=512, **CPU)
    res = online.update(model0, state0, ArraySource(grown), **CPU)
    _assert_bit_equal(res.model, streaming.fit(ArraySource(grown), cfg, chunk_rows=512, **CPU))
    assert res.stats["replayed_degrees"], "expected the new data to flip a degree"
    assert res.stats["folded_degrees"] > 0
    # the reference folds and replays the same degrees
    jres = jonline.update(*jonline.fit(jstreaming.ArraySource(base), JConfig(
        psi=0.005, engine="fast", ordering="none", cap_terms=64), chunk_rows=512),
        jstreaming.ArraySource(grown))
    assert res.stats["replayed_degrees"] == jres.stats["replayed_degrees"]
    assert res.stats["folded_degrees"] == jres.stats["folded_degrees"]
    assert res.model.book.terms == jres.model.book.terms


def test_update_perm_change_drops_records(stream):
    """A feature-order flip relabels the book's columns: no record survives
    and the update replays everything, still equal to the refit."""
    view, _ = stream
    base = np.asarray(view(2560).read(0, 2560))
    extra = np.zeros((1280, 3), np.float32)
    extra[:, 0] = 0.5
    extra[:, 2] = np.linspace(0, 1, 1280, dtype=np.float32)
    grown = np.concatenate([base, extra])
    model0, state0 = online.fit(ArraySource(base), CFG, chunk_rows=512, **CPU)
    res = online.update(model0, state0, ArraySource(grown), **CPU)
    assert res.stats["refit_reason"] == "feature_order_changed"
    assert res.stats["folded_degrees"] == 0
    _assert_bit_equal(res.model, streaming.fit(ArraySource(grown), CFG, chunk_rows=512, **CPU))


def test_update_matches_reference(stream):
    """The reference updates the same stream to the same structure, folding
    the same degrees; coefficients at the in-memory parity tolerance of
    tests/test_torch_oavi.py (rtol 5e-3, atol 2e-3, the inverse engine)."""
    view, scaler = stream
    res = online.update(*online.fit(view(M_BASE), CFG, chunk_rows=512, **CPU), view(M_FULL),
                        **CPU)
    jview = lambda m: jstreaming.ScaledSource(j_synth.planted_source(m, n=3, seed=3),  # noqa
                                              scaler)
    jres = jonline.update(*jonline.fit(jview(M_BASE), JCFG, chunk_rows=512), jview(M_FULL))
    assert res.model.book.terms == jres.model.book.terms
    assert [g.term for g in res.model.generators] == [g.term for g in jres.model.generators]
    for gp, gr in zip(res.model.generators, jres.model.generators):
        np.testing.assert_allclose(gp.coeffs, gr.coeffs, rtol=5e-3, atol=2e-3)
    for key in ("folded_degrees", "replayed_degrees", "refit_reason", "chunks", "new_rows"):
        assert res.stats[key] == jres.stats[key], key
    assert np.array_equal(res.state.moments[0], jres.state.moments[0])
    assert res.state.moment_rows == jres.state.moment_rows
    assert res.state.aligned_rows == jres.state.aligned_rows


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------


def test_update_rejections(stream):
    view, _ = stream
    model0, state0 = online.fit(view(M_BASE), CFG, chunk_rows=512, **CPU)
    with pytest.raises(ValueError, match="shrank"):
        online.update(model0, state0, view(M_BASE - 512), **CPU)
    tampered = np.asarray(view(M_FULL).read(0, M_FULL)).copy()
    tampered[0, 0] += 0.25  # a row the state already accumulated
    with pytest.raises(ValueError, match="prefix mismatch"):
        online.update(model0, state0, ArraySource(tampered), **CPU)
    other, _ = online.fit(view(M_BASE), OAVIConfig(psi=0.5, engine="fast", cap_terms=64),
                          chunk_rows=512, **CPU)
    assert other.book.terms != model0.book.terms
    with pytest.raises(ValueError, match="does not belong"):
        online.update(other, state0, view(M_FULL), **CPU)
    with pytest.raises(ValueError, match="features"):
        online.update(model0, state0, ArraySource(np.zeros((4000, 5), np.float32)), **CPU)
    with pytest.raises(ValueError, match="chunk_rows"):
        online.update(model0, state0, view(M_FULL), chunk_rows=300, **CPU)


def test_update_with_another_chunk_size_still_equals_refit(stream):
    view, _ = stream
    model0, state0 = online.fit(view(M_BASE), CFG, chunk_rows=512, **CPU)
    res = online.update(model0, state0, view(M_FULL), chunk_rows=1024, **CPU)
    assert res.stats["refit_reason"] == "chunk_rows_changed"
    assert res.stats["folded_degrees"] > 0  # the Gram records still fold
    _assert_bit_equal(res.model, streaming.fit(view(M_FULL), CFG, chunk_rows=1024, **CPU))


# ---------------------------------------------------------------------------
# FitState: save / load, across packages
# ---------------------------------------------------------------------------


def test_fit_state_save_load_update_round_trip(stream, tmp_path):
    view, _ = stream
    model0, state0 = online.fit(view(M_BASE), CFG, chunk_rows=512, **CPU)
    state0.save(str(tmp_path / "state"))
    loaded = FitState.load(str(tmp_path / "state"))
    assert loaded.config == state0.config
    _assert_states_equal(loaded, state0)
    res = online.update(model0, loaded, view(M_FULL), **CPU)
    _assert_bit_equal(res.model, streaming.fit(view(M_FULL), CFG, chunk_rows=512, **CPU))
    with pytest.raises(ValueError, match="format"):
        api.load_state_dict(str(tmp_path / "state"), "repro.some_other_format.v1")


@pytest.mark.parametrize("saver", ["port", "reference"])
def test_fit_state_crosses_packages(stream, tmp_path, saver):
    """A state saved by one package loads in the other, with the same
    records, and each package's update from it equals its own refit."""
    view, scaler = stream
    jview = lambda m: jstreaming.ScaledSource(j_synth.planted_source(m, n=3, seed=3),  # noqa
                                              scaler)
    path = str(tmp_path / "state")
    if saver == "port":
        model0, state0 = online.fit(view(M_BASE), CFG, chunk_rows=512, scaler=scaler, **CPU)
        state0.save(path)
        loaded = jonline.FitState.load(path)
        assert loaded.config == JCFG
        jres = jonline.update(None, loaded, jview(M_FULL))
        ref = jstreaming.fit(jview(M_FULL), JCFG, chunk_rows=512)
        _assert_bit_equal(jres.model, ref)
        assert jres.stats["folded_degrees"] == len(state0.records)
    else:
        jmodel0, jstate0 = jonline.fit(jview(M_BASE), JCFG, chunk_rows=512, scaler=scaler)
        jstate0.save(path)
        loaded = FitState.load(path)
        assert loaded.config == CFG
        state0 = jstate0
        res = online.update(None, loaded, view(M_FULL), **CPU)
        _assert_bit_equal(res.model, streaming.fit(view(M_FULL), CFG, chunk_rows=512, **CPU))
        assert res.stats["folded_degrees"] == len(loaded.records)
        assert np.array_equal(loaded.scaler_hi, scaler.hi)
    # the loading package writes back the saver's arrays, names and metadata
    a_arr, a_meta = state0.to_state_dict()
    b_arr, b_meta = loaded.to_state_dict()
    assert sorted(a_arr) == sorted(b_arr)
    for key in a_arr:
        assert np.array_equal(a_arr[key], b_arr[key]) and a_arr[key].dtype == b_arr[key].dtype
    assert a_meta == b_meta


# ---------------------------------------------------------------------------
# api / pipeline wiring
# ---------------------------------------------------------------------------


def test_api_capture_state_and_update(stream):
    view, _ = stream
    model = api.fit(view(M_BASE), "oavi:fast", psi=0.005, chunk_rows=512, capture_state=True,
                    ordering="pearson", cap_terms=64, **CPU)
    assert isinstance(model.fit_state, FitState)
    assert model.stats["api"]["online"] is True and model.stats["api"]["streaming"] is True
    res = api.update(model, model.fit_state, view(M_FULL), **CPU)
    _assert_bit_equal(res.model, streaming.fit(view(M_FULL), CFG, chunk_rows=512, **CPU))
    assert res.model.fit_state is res.state
    assert res.model.stats["api"]["online"] is True
    assert res.model.stats["api"]["method"] == "oavi:fast"
    with pytest.raises(ValueError, match="capture_state"):
        api.fit(random_cube(512, 3, seed=0), "oavi:fast", capture_state=True, **CPU)


def test_pipeline_capture_fit_state(tmp_path):
    from repro_torch.core.pipeline import PipelineConfig, VanishingIdealClassifier

    rng = np.random.default_rng(0)
    X = rng.uniform(0, 1, (1200, 3)).astype(np.float32)
    y = (X[:, 0] > 0.5).astype(int)
    cfg = PipelineConfig(method="oavi:fast", psi=0.01, chunk_rows=512, capture_fit_state=True,
                         oavi_kw={"cap_terms": 64, "max_degree": 3})
    clf = VanishingIdealClassifier(cfg, device="cpu").fit(X, y)
    assert len(clf.fit_states) == len(clf.models) == 2
    Xs = clf.scaler.transform(X)
    for c, model, state in zip(clf.classes_, clf.models, clf.fit_states):
        assert state.num_rows == int(np.sum(y == c))
        assert np.array_equal(np.asarray(model.book.parents, np.int32), state.book_parents)
        # each class's state updates like any other
        grown = np.concatenate([Xs[y == c], Xs[y == c][:300]])
        res = api.update(model, state, grown, **CPU)
        _assert_bit_equal(res.model, api.fit(grown, "oavi:fast", psi=0.01, chunk_rows=512,
                                              cap_terms=64, max_degree=3, **CPU))
    clf.save(str(tmp_path / "clf"))
    loaded = VanishingIdealClassifier.load(str(tmp_path / "clf"), device="cpu")
    assert loaded.config == cfg
    with pytest.raises(ValueError, match="chunk_rows"):
        VanishingIdealClassifier(PipelineConfig(capture_fit_state=True), device="cpu").fit(
            np.zeros((64, 3), np.float32), np.zeros(64, int))


# ---------------------------------------------------------------------------
# drift monitor: the reference's signals
# ---------------------------------------------------------------------------


def _drift_window(view, kind):
    rows = np.asarray(view(M_FULL).read(M_BASE, M_FULL))
    return {"same": rows, "shifted": rows * 0.9 + 0.4,
            "tiny": np.full((100, 3), 5.0, np.float32),
            "squeezed": 0.5 + 0.1 * (rows - 0.5)}[kind]


@pytest.mark.parametrize("kind,fires", [("same", []), ("shifted", ["mean_shift", "oob_frac"]),
                                        ("tiny", []), ("squeezed", ["mse0_ratio"])])
def test_drift_signals_equal_reference(stream, kind, fires):
    view, _ = stream
    _, state0 = online.fit(view(M_BASE), CFG, chunk_rows=512, **CPU)
    _, jstate0 = jonline.fit(view(M_BASE), JCFG, chunk_rows=512)
    mon = DriftMonitor.from_fit_state(state0)
    jmon = jonline.DriftMonitor.from_fit_state(jstate0)
    for m in (mon, jmon):
        m.observe(_drift_window(view, kind))
    trig, sig = mon.should_refit()
    jtrig, jsig = jmon.should_refit()
    assert sig == jsig and trig == jtrig
    assert [f for f in fires if f in sig["triggered"]] == fires
    assert trig == bool(fires)


def test_drift_gate_rebase_and_moments(stream):
    view, _ = stream
    _, state0 = online.fit(view(M_BASE), CFG, chunk_rows=512, **CPU)
    mon = DriftMonitor.from_fit_state(state0, DriftConfig(min_rows=512))
    mon.observe(np.full((100, 3), 5.0, np.float32))  # wildly off, but tiny
    assert not mon.should_refit()[0]
    mon.observe(np.full((412, 3), 5.0, np.float32))
    assert mon.should_refit()[0]
    mon.reset_window()
    mon.observe(_drift_window(view, "same"))
    assert mon.window_rows == M_FULL - M_BASE
    mon.rebase()
    assert mon.window_rows == 0 and mon.signals()["mean_shift"] == 0.0
    _, plain = online.fit(ArraySource(random_cube(512, 3, seed=1)),
                          OAVIConfig(psi=0.005, ordering="none", cap_terms=64),
                          chunk_rows=512, **CPU)
    with pytest.raises(ValueError, match="moment"):
        DriftMonitor.from_fit_state(plain)
    with pytest.raises(ValueError):
        DriftConfig(mse0_ratio=0.5)


# ---------------------------------------------------------------------------
# shard growth (append / refresh / partial writes)
# ---------------------------------------------------------------------------


def test_shard_append_refresh_round_trip(tmp_path):
    d = str(tmp_path / "shards")
    a, b = random_cube(1024, 3, seed=0), random_cube(512, 3, seed=1)
    write_shards(d, a, shard_rows=512)
    src = ShardDirSource(d)
    write_shards(d, b, append=True)
    assert src.num_rows == 1024  # unseen until refresh
    assert src.refresh() == 512 and src.num_rows == 1536
    assert np.array_equal(src.read(0, 1536), np.concatenate([a, b]))
    assert src.refresh() == 0
    jsrc = jstreaming.ShardDirSource(d)
    assert np.array_equal(jsrc.read(0, 1536), src.read(0, 1536))


def test_shard_append_rejections(tmp_path):
    import json
    import os

    d = str(tmp_path / "partial")
    write_shards(d, random_cube(700, 3, seed=0), shard_rows=512)
    with pytest.raises(ValueError, match="multiple of shard_rows"):
        write_shards(d, random_cube(512, 3, seed=1), append=True)
    d = str(tmp_path / "schema")
    write_shards(d, random_cube(512, 3, seed=0), shard_rows=512)
    with pytest.raises(ValueError, match="append mismatch"):
        write_shards(d, random_cube(512, 4, seed=1), append=True)
    d = str(tmp_path / "torn")
    write_shards(d, random_cube(1024, 3, seed=0), shard_rows=512)
    src = ShardDirSource(d)
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    meta["num_rows"], meta["num_shards"] = 512, 1
    with open(os.path.join(d, "meta.json"), "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match="shrink"):
        src.refresh()
    meta["num_rows"], meta["num_shards"] = 2048, 4
    with open(os.path.join(d, "meta.json"), "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match="partial write"):
        ShardDirSource(d)


def test_online_update_over_growing_shard_dir(tmp_path):
    """Append, refresh, update: equal to the refit of everything."""
    d = str(tmp_path / "shards")
    base = np.asarray(planted_source(2560, n=3, seed=2).read(0, 2560))
    more = np.asarray(planted_source(3584, n=3, seed=2).read(2560, 3584))
    write_shards(d, base, shard_rows=512)
    raw = ShardDirSource(d)
    scaler = StreamingMinMaxScaler(dtype="float32").fit(base)
    src = ScaledSource(raw, scaler)
    model0, state0 = online.fit(src, CFG, chunk_rows=512, **CPU)
    write_shards(d, more, append=True)
    assert raw.refresh() == 1024
    res = online.update(model0, state0, src, **CPU)
    ref = streaming.fit(ScaledSource(ArraySource(np.concatenate([base, more])), scaler), CFG,
                        chunk_rows=512, **CPU)
    _assert_bit_equal(res.model, ref)


# ---------------------------------------------------------------------------
# prefetch
# ---------------------------------------------------------------------------


def test_prefetch_map_preserves_order():
    staged = []
    out = list(prefetch_map(lambda i: staged.append(i) or i * i, range(6)))
    assert out == [0, 1, 4, 9, 16, 25] and staged == list(range(6))
    assert list(prefetch_map(lambda i: i, [])) == []
    assert list(prefetch_map(lambda i: i, [7], enabled=False)) == [7]


def test_online_prefetch_on_equals_off(stream):
    view, _ = stream
    model0, state0 = online.fit(view(M_BASE), CFG, chunk_rows=256, **CPU)
    a = online.update(model0, state0, view(M_FULL), **CPU)
    b = online.update(model0, state0, view(M_FULL), prefetch=False, **CPU)
    _assert_bit_equal(a.model, b.model)
    _assert_states_equal(a.state, b.state)
