"""The port's serving stack (``repro_torch.serving``, ``launch/serve_vi``) on
the CPU.

The cases of the reference's ``tests/test_serving.py`` on the port: the
engine against the port's own direct transform **bit for bit** (buckets,
chunked requests, the empty request, wrong widths), the batcher, classifier
save/load and ``attach_engine``, the registry, and ``serve_vi`` in process.
The sharded engine (``mesh=``, k spans on k ``cpu`` devices here) against
the local engine bit for bit, and its buckets against the reference
engine's rule.  Then parity with the JAX package's engine on a classifier
carried across, and the chaos paths (transient fault, poison request,
expired deadline, failed activation, and the checkpoint store's and shard
writer's sites), each against a fault-free run, bit for bit.
"""

import os

import numpy as np
import pytest

from repro_torch import api
from repro_torch.core.pipeline import PipelineConfig, VanishingIdealClassifier
from repro_torch.resilience import chaos
from repro_torch.resilience.chaos import (
    Fault,
    FaultPlan,
    InjectedFault,
    PoisonRequestError,
    TransientEngineError,
)
from repro_torch.resilience.integrity import IntegrityError
from repro_torch.serving import (
    BatcherConfig,
    DeadlineExceeded,
    EngineConfig,
    MicroBatcher,
    ModelRegistry,
    ShutdownError,
    TransformEngine,
    UnsupportedModelError,
    load_servable,
)

CFG = EngineConfig(min_bucket=32, max_bucket=512)
CPU = "cpu"


@pytest.fixture(autouse=True)
def _no_plan():
    chaos.uninstall()
    yield
    chaos.uninstall()


@pytest.fixture(scope="module")
def planted():
    rng = np.random.default_rng(0)
    X = rng.uniform(0, 1, (900, 4)).astype(np.float32)
    X[:, 3] = np.clip(X[:, 0] * X[:, 1] + rng.normal(0, 0.01, 900), 0, 1)
    return X


@pytest.fixture(scope="module")
def labels(planted):
    return (planted[:, 0] > 0.5).astype(int)


@pytest.fixture(scope="module")
def models(planted, labels):
    return [api.fit(planted[labels == c], "oavi:fast", psi=0.005, cap_terms=64, device=CPU)
            for c in np.unique(labels)]


@pytest.fixture(scope="module")
def classifier(planted, labels):
    clf = VanishingIdealClassifier(
        PipelineConfig(method="oavi:fast", psi=0.005, oavi_kw={"cap_terms": 64}), device=CPU)
    return clf.fit(planted, labels)


def _queries(q, seed=1, n=4):
    return np.random.default_rng(seed).uniform(0, 1, (q, n)).astype(np.float32)


def _direct(models, Z):
    return api.feature_transform(models, Z, device=CPU)


# -- engine -------------------------------------------------------------------


def test_engine_bit_identical_to_direct_path(models):
    eng = TransformEngine(models, device=CPU, config=CFG)
    for q in (1, 2, 3, 31, 32, 33, 100, 512, 700):
        Z = _queries(q, seed=q)
        direct = _direct(models, Z)
        served = eng.transform(Z)
        assert served.dtype == direct.dtype
        assert np.array_equal(served, direct), f"q={q} not bit-identical"


def test_engine_buckets_pow2_clamped(models):
    eng = TransformEngine(models, device=CPU, config=CFG)
    assert eng.buckets() == (32, 64, 128, 256, 512)
    assert (eng.bucket_for(1), eng.bucket_for(32), eng.bucket_for(33)) == (32, 32, 64)
    assert eng.bucket_for(512) == 512 and eng.bucket_for(10_000) == 512


def test_engine_ragged_sizes_one_recompile_per_bucket(models):
    eng = TransformEngine(models, device=CPU, config=CFG)
    sizes = [3, 31, 32, 33, 63, 64, 65, 100, 127, 128, 129, 400]
    for q in sizes:
        Z = _queries(q, seed=q)
        assert np.array_equal(eng.transform(Z), _direct(models, Z))
    assert eng.stats["recompiles"] == len({eng.bucket_for(q) for q in sizes})
    before = eng.stats["recompiles"]
    for q in sizes:
        eng.transform(_queries(q, seed=q))
    assert eng.stats["recompiles"] == before and eng.stats["padded_rows"] > 0


def test_engine_warmup_then_zero_recompiles(models):
    eng = TransformEngine(models, device=CPU, config=CFG)
    warmed = eng.warmup()
    assert warmed == len(eng.buckets())
    assert eng.warmup() == 0  # idempotent
    for q in (1, 17, 33, 129, 511, 2000):
        eng.transform(_queries(q, seed=q))
    st = eng.stats
    assert st["recompiles"] == 0 and st["warmup_compiles"] == warmed
    assert st["compile_seconds"] == 0.0  # the serving call builds no kernel


def test_engine_flops_per_bucket_is_the_analytic_count(models):
    """``b * (2 L k + L + k - 1)`` for the fused book's L terms and k
    features, the same number on either device."""
    eng = TransformEngine(models, device=CPU, config=CFG)
    eng.warmup()
    L, k = eng.terms, eng.consts.num_features
    assert L == len(eng.plan.parents) and eng.consts.C_w.shape == (L, k)
    assert eng.stats["flops_per_bucket"] == {
        b: float(b) * (2.0 * L * k + L + k - 1) for b in eng.buckets()}
    eng.transform(_queries(40))
    assert eng.stats["flops_dispatched"] == 64.0 * (2.0 * L * k + L + k - 1)
    assert eng.stats["achieved_gflops"] > 0


def test_engine_chunks_requests_beyond_max_bucket(models):
    eng = TransformEngine(models, device=CPU, config=CFG)
    eng.warmup()
    Z = _queries(1100, seed=9)  # 512 + 512 + 76 -> 3 device calls
    assert np.array_equal(eng.transform(Z), _direct(models, Z))
    assert eng.stats["device_calls"] == 3 and eng.stats["recompiles"] == 0
    assert eng.stats["buckets"] == {128: 1, 512: 2}


def test_engine_empty_request_and_wrong_width(models):
    eng = TransformEngine(models, device=CPU, config=CFG)
    assert eng.transform(np.zeros((0, 4), np.float32)).shape == (0, eng.consts.num_features)
    with pytest.raises(ValueError, match="expected"):
        eng.transform(np.zeros((5, 7), np.float32))
    with pytest.raises(ValueError, match="min_bucket"):
        EngineConfig(min_bucket=64, max_bucket=32)


class _WorldMesh:
    """The two methods of a ``DeviceMesh`` the engine reads."""

    def __init__(self, world, device_type="cpu"):
        self.world, self.device_type = world, device_type

    def size(self):
        return self.world


def test_engine_rejects_vca_and_mesh(planted, models):
    """VCA has no fused plan; a mesh is a sequence of devices (a
    ``DeviceMesh`` of world 1 is its one device, a larger one raises)."""
    vca = api.fit(planted, "vca", psi=0.005, device=CPU)
    with pytest.raises(UnsupportedModelError, match="term-book"):
        TransformEngine([vca], device=CPU, config=CFG)
    with pytest.raises(UnsupportedModelError, match="term-book"):
        TransformEngine([vca], mesh=[CPU, CPU], config=CFG)
    with pytest.raises(ValueError, match="SPMD"):
        TransformEngine(models, mesh=_WorldMesh(2), config=CFG)
    with pytest.raises(ValueError, match="at least one"):
        TransformEngine(models, mesh=[], config=CFG)
    one = TransformEngine(models, mesh=_WorldMesh(1), config=CFG)
    assert one.shards == 1 and one.backend == "sharded"
    two = TransformEngine(models, mesh=[CPU, "cpu"], config=CFG)
    assert two.shards == 2 and two.backend == "sharded"
    assert "sharded(shards=2" in repr(two)
    Z = _queries(77)
    local = TransformEngine(models, device=CPU, config=CFG).transform(Z)
    assert np.array_equal(one.transform(Z), local)
    assert np.array_equal(two.transform(Z), local)


@pytest.mark.parametrize("shards", [1, 2, 3, 4, 8])
def test_sharded_buckets_match_reference(shards):
    """``bucket_for`` and ``buckets`` are the reference engine's rule
    (``src/repro/serving/engine.py``): its methods read only ``shards``,
    ``min_bucket`` and ``max_bucket``, set here as its constructor sets
    them for a mesh of ``shards`` data shards."""
    from repro.core.oavi import pow2_bucket as jpow2
    from repro.serving.engine import TransformEngine as JEngine
    from repro_torch.serving.engine import TransformEngine as Engine

    for cfg in (EngineConfig(), EngineConfig(min_bucket=1, max_bucket=256),
                EngineConfig(min_bucket=5, max_bucket=100), CFG):
        ref = object.__new__(JEngine)
        ref.shards = shards
        ref.min_bucket = ref._round_to_shards(max(jpow2(cfg.min_bucket), 2 * shards))
        ref.max_bucket = ref._round_to_shards(max(jpow2(cfg.max_bucket), ref.min_bucket))
        eng = object.__new__(Engine)
        eng.shards = shards
        eng.min_bucket = eng._round_to_shards(max(jpow2(cfg.min_bucket), 2 * shards))
        eng.max_bucket = eng._round_to_shards(max(jpow2(cfg.max_bucket), eng.min_bucket))
        assert eng.buckets() == ref.buckets()
        for q in list(range(1, 300)) + [511, 512, 513, 4097, 20_000]:
            assert eng.bucket_for(q) == ref.bucket_for(q), (cfg, q)


def test_sharded_engine_constructor_buckets(models):
    """The constructor sets ``min_bucket``/``max_bucket`` by that rule."""
    for k in (1, 2, 3, 4, 8):
        for cfg in (EngineConfig(), EngineConfig(min_bucket=1, max_bucket=256), CFG):
            eng = TransformEngine(models, mesh=[CPU] * k, config=cfg)
            lo = -(-max(max(2, 1 << (cfg.min_bucket - 1).bit_length()), 2 * k) // k) * k
            assert eng.min_bucket == lo and eng.max_bucket % k == 0
            assert all(b % k == 0 and b // k >= 2 for b in eng.buckets())


@pytest.mark.parametrize("k", [2, 3, 4])
def test_sharded_engine_bits_equal_local(models, k):
    """k spans on k ``cpu`` devices give the local engine's bits for every
    row count from 1 to 300, and for a request beyond ``max_bucket``."""
    cfg = EngineConfig(min_bucket=8, max_bucket=128)
    local = TransformEngine(models, device=CPU, config=cfg)
    sharded = TransformEngine(models, mesh=[CPU] * k, config=cfg)
    Z = _queries(700, seed=k)
    for q in range(1, 301):
        assert np.array_equal(sharded.transform(Z[:q]), local.transform(Z[:q])), q
    assert np.array_equal(sharded.transform(Z), _direct(models, Z))
    st = sharded.stats
    assert st["requests"] == 301 and st["device_calls"] >= 301


def test_engine_device_rule(models, monkeypatch):
    """``device=None`` means the card, and raises without one."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TransformEngine(models, config=CFG)
    with pytest.raises(RuntimeError):
        ModelRegistry()


def test_feature_transform_engine_kwarg(models):
    eng = TransformEngine(models, device=CPU, config=CFG)
    Z = _queries(77)
    assert np.array_equal(api.feature_transform(models, Z, engine=eng), _direct(models, Z))
    assert api.feature_transform(models, Z, engine=eng, dtype="float64").dtype == np.float64
    with pytest.raises(ValueError, match="different model set"):
        api.feature_transform(models[:1], Z, engine=eng)


# -- batcher ------------------------------------------------------------------


def _engine(models):
    eng = TransformEngine(models, device=CPU, config=CFG)
    eng.warmup()
    return eng


def test_batcher_run_once_coalesces_bit_exact(models):
    bat = MicroBatcher(_engine(models), config=BatcherConfig(max_batch_rows=256))
    Zs = [_queries(q, seed=q) for q in (5, 17, 64, 9, 33)]
    futs = [bat.submit(Z) for Z in Zs]
    assert bat.run_once() == len(Zs)
    assert bat.stats["batches"] == 1  # 128 rows coalesce into one call
    for Z, f in zip(Zs, futs):
        assert np.array_equal(f.result(timeout=0), _direct(models, Z))


def test_batcher_respects_max_batch_rows(models):
    bat = MicroBatcher(_engine(models), config=BatcherConfig(max_batch_rows=64))
    futs = [bat.submit(_queries(40, seed=i)) for i in range(4)]
    bat.run_once()
    assert bat.stats["batches"] == 4 and all(f.done() for f in futs)


def test_batcher_threaded_predict_and_transform(classifier):
    eng = TransformEngine(classifier.models, device=CPU, config=CFG)
    eng.warmup()
    Z = _queries(150, seed=2)
    Zs = classifier.scaler.transform(Z)
    with MicroBatcher(eng, head=classifier.head) as bat:
        f_t = bat.submit(Zs, "transform")
        f_p = bat.submit(Zs, "predict")
        feats = f_t.result(timeout=30)
        preds = f_p.result(timeout=30)
    assert np.array_equal(preds, classifier.predict(Z))
    assert np.array_equal(feats, classifier.transform(Z))


def test_batcher_config_validation():
    with pytest.raises(ValueError, match="max_queue"):
        BatcherConfig(max_queue=0)
    with pytest.raises(ValueError, match="max_batch_rows"):
        BatcherConfig(max_batch_rows=0)
    with pytest.raises(ValueError, match="max_delay_ms"):
        BatcherConfig(max_delay_ms=-1.0)


def test_batcher_unstarted_prequeue_beyond_max_queue_never_blocks(models):
    bat = MicroBatcher(_engine(models), config=BatcherConfig(max_queue=2))
    futs = [bat.submit(_queries(4, seed=i)) for i in range(6)]
    out = bat.transform(_queries(4))
    assert out.shape[0] == 4 and all(f.done() for f in futs)


def test_batcher_malformed_requests_and_kinds(models):
    bat = MicroBatcher(_engine(models))
    with pytest.raises(ValueError, match="head"):
        bat.submit(_queries(4), "predict")
    with pytest.raises(ValueError, match="unknown request kind"):
        bat.submit(_queries(4), "decode")
    with pytest.raises(ValueError, match="expected"):
        bat.submit(np.zeros((5, 9), np.float32))
    with pytest.raises(ValueError, match="expected"):
        bat.submit(np.zeros((4,), np.float32))
    good = bat.submit(_queries(5))
    bat.run_once()
    assert good.result(timeout=0).shape == (5, bat.engine.consts.num_features)


def test_batcher_submit_after_stop_raises_then_restartable(models):
    bat = MicroBatcher(_engine(models))
    bat.start()
    bat.stop()
    with pytest.raises(ShutdownError, match="stopped"):
        bat.submit(_queries(4))
    bat.start()
    try:
        assert bat.submit(_queries(4)).result(timeout=30).shape[0] == 4
    finally:
        bat.stop()


def test_batcher_propagates_processing_errors(models):
    def bad_head(feats):
        raise RuntimeError("head exploded")

    bat = MicroBatcher(_engine(models), head=bad_head)
    fut = bat.submit(_queries(5), "predict")
    ok = bat.submit(_queries(3))
    bat.run_once()
    with pytest.raises(RuntimeError, match="head exploded"):
        fut.result(timeout=0)
    assert ok.result(timeout=0).shape[0] == 3


def test_batcher_stop_fails_pending_with_shutdown_error(models):
    bat = MicroBatcher(_engine(models), config=BatcherConfig(max_delay_ms=0.0))
    futs = [bat.submit(_queries(2, seed=20 + i)) for i in range(3)]
    bat.stop(drain=False)
    for f in futs:
        with pytest.raises(ShutdownError):
            f.result(timeout=5)
    assert bat.stats["shutdown_failed"] == 3


# -- classifier serialization + engine routing --------------------------------


def test_classifier_save_load_predict_bit_identical(classifier, tmp_path):
    path = str(tmp_path / "clf")
    committed = classifier.save(path)
    assert os.path.exists(os.path.join(committed, "COMMITTED"))
    restored = VanishingIdealClassifier.load(path, device=CPU)
    Z = _queries(333, seed=11)
    assert np.array_equal(restored.predict(Z), classifier.predict(Z))
    assert np.array_equal(restored.transform(Z), classifier.transform(Z))


def test_classifier_attach_engine_predict_identical(classifier):
    Z = _queries(257, seed=12)
    base_pred = classifier.predict(Z)
    base_feat = classifier.transform(Z)
    eng = classifier.attach_engine(engine_config=CFG)
    try:
        assert eng is classifier.engine and eng.matches(classifier.models)
        assert eng.device == classifier.device
        assert np.array_equal(classifier.predict(Z), base_pred)
        assert np.array_equal(classifier.transform(Z), base_feat)
        assert eng.stats["requests"] >= 2 and eng.stats["recompiles"] == 0
        with pytest.raises(ValueError, match="different model set"):
            classifier.attach_engine(TransformEngine(classifier.models[:1], device=CPU))
    finally:
        classifier.engine = None  # module-scoped fixture: leave it clean


def test_classifier_refit_drops_stale_engine(planted, labels):
    clf = VanishingIdealClassifier(
        PipelineConfig(method="oavi:fast", psi=0.005, oavi_kw={"cap_terms": 64}), device=CPU)
    clf.fit(planted, labels)
    eng = clf.attach_engine(engine_config=CFG)
    clf.fit(planted, labels)  # refit: the old engine no longer matches
    served = eng.stats["requests"]
    clf.predict(planted[:16])
    assert eng.stats["requests"] == served  # the stale engine is bypassed


def test_classifier_attach_engine_vca_falls_back(planted, labels):
    clf = VanishingIdealClassifier(PipelineConfig(method="vca", psi=0.005), device=CPU)
    clf.fit(planted, labels)
    assert clf.attach_engine() is None and clf.engine is None
    assert clf.predict(planted[:32]).shape == (32,)


# -- registry -----------------------------------------------------------------


def test_registry_save_load_serve_bit_matches_direct(classifier, tmp_path):
    path = str(tmp_path / "clf")
    classifier.save(path)
    reg = ModelRegistry(device=CPU, engine_config=CFG)
    entry = reg.load("default", path)
    assert entry.engine is not None and entry.engine.stats["warmup_compiles"] > 0
    Z = _queries(181, seed=13)
    direct = _direct(list(entry.models), entry.scale(Z))
    assert np.array_equal(entry.transform(Z), direct)
    assert np.array_equal(entry.predict(Z), classifier.predict(Z))
    assert entry.engine.stats["recompiles"] == 0
    assert entry.num_features == direct.shape[1]


def test_registry_load_single_model(models, tmp_path):
    api.save(models[0], str(tmp_path / "m"))
    reg = ModelRegistry(device=CPU, engine_config=CFG)
    entry = reg.load("gen", str(tmp_path / "m"))
    Z = _queries(64, seed=14)
    assert np.array_equal(entry.transform(Z), _direct(list(entry.models), Z))
    with pytest.raises(ValueError, match="bare model"):
        entry.predict(Z)


def test_load_servable_dispatch(classifier, models, tmp_path):
    classifier.save(str(tmp_path / "c"))
    api.save(models[0], str(tmp_path / "m"))
    assert isinstance(load_servable(str(tmp_path / "c"), device=CPU), VanishingIdealClassifier)
    assert type(load_servable(str(tmp_path / "m"), device=CPU)) is type(models[0])
    with pytest.raises(FileNotFoundError):
        load_servable(str(tmp_path / "missing"), device=CPU)


def test_registry_hot_swap_versions(classifier):
    reg = ModelRegistry(device=CPU, engine_config=CFG, warmup=False)
    e1 = reg.register("default", classifier)
    e2 = reg.register("default", classifier)
    assert (e1.version, e2.version) == (1, 2)
    assert reg.active_version("default") == 2
    reg.activate("default", 1)
    assert reg.get("default").version == 1 and reg.get("default", version=2) is e2
    assert reg.versions("default") == (1, 2)
    staged = reg.register("default", classifier, activate=False)
    assert reg.active_version("default") == 1
    reg.activate("default", staged.version)
    assert reg.get("default") is staged
    fresh = reg.register("fresh", classifier, activate=False)
    assert reg.active_version("fresh") is None
    with pytest.raises(KeyError, match="staged"):
        reg.get("fresh")
    reg.activate("fresh", fresh.version)
    assert reg.get("fresh") is fresh
    with pytest.raises(KeyError, match="no version"):
        reg.get("default", version=99)
    with pytest.raises(KeyError):
        reg.activate("default", 99)
    with pytest.raises(ValueError, match="already registered"):
        reg.register("default", classifier, version=1)
    # a sharded registry: every engine over the mesh, the local replies
    sharded = ModelRegistry(mesh=[CPU] * 3, engine_config=CFG, warmup=False)
    entry = sharded.register("default", classifier)
    assert entry.engine.shards == 3 and sharded.device.type == "cpu"
    Z = _queries(50)
    assert np.array_equal(entry.transform(Z, scaled=True), e1.transform(Z, scaled=True))
    assert np.array_equal(entry.predict(Z, scaled=True), classifier.head(_direct(
        classifier.models, Z)))


def test_registry_remove_repoints_active(classifier):
    reg = ModelRegistry(device=CPU, engine_config=CFG, warmup=False)
    reg.register("m", classifier)
    reg.register("m", classifier)
    reg.remove("m", 2)
    assert reg.active_version("m") == 1
    reg.remove("m")
    with pytest.raises(KeyError):
        reg.get("m")
    assert reg.names() == ()
    reg.register("s", classifier)
    reg.register("s", classifier, activate=False)
    reg.remove("s", 1)
    assert reg.active_version("s") is None
    with pytest.raises(KeyError, match="staged"):
        reg.get("s")


# -- the serve_vi CLI ---------------------------------------------------------


def test_serve_vi_cli_in_process(tmp_path):
    from repro_torch.launch import serve_vi

    replies = []
    report = serve_vi.main([
        "--device", "cpu", "--fit-m", "600", "--requests", "24", "--mean-rows", "32",
        "--concurrency", "4", "--min-bucket", "32", "--max-bucket", "512",
        "--model-dir", str(tmp_path / "ckpt"),
    ], replies=replies)
    assert report["requests"] == 24 and report["recompiles"] == 0
    assert report["rows_per_s"] > 0 and report["device"] == "cpu"
    assert len(replies) == 24 and all(r is not None for r in replies)
    # the second run loads the checkpoint; its transform replies are the
    # direct transform of the same payloads, bit for bit
    replies2 = []
    report2 = serve_vi.main([
        "--device", "cpu", "--requests", "8", "--mean-rows", "32", "--concurrency", "2",
        "--min-bucket", "32", "--max-bucket", "512", "--kind", "transform",
        "--model-dir", str(tmp_path / "ckpt"),
    ], replies=replies2)
    assert report2["recompiles"] == 0
    clf = VanishingIdealClassifier.load(str(tmp_path / "ckpt"), device=CPU)
    payloads = serve_vi.make_payloads(clf.scaler.transform,
                                      serve_vi.synth_trace(8, 32, 0), 0)
    for p, r in zip(payloads, replies2):
        assert np.array_equal(r, _direct(clf.models, p))
    # --sharded: three spans on the CPU, the same replies bit for bit
    replies3 = []
    report3 = serve_vi.main([
        "--device", "cpu", "--sharded", "--mesh-shape", "3", "--requests", "8",
        "--mean-rows", "32", "--concurrency", "2", "--min-bucket", "32",
        "--max-bucket", "512", "--kind", "transform", "--model-dir", str(tmp_path / "ckpt"),
    ], replies=replies3)
    assert report3["shards"] == 3 and report3["recompiles"] == 0
    assert all(np.array_equal(a, b) for a, b in zip(replies3, replies2))
    with pytest.raises(ValueError, match="one axis"):
        serve_vi.main(["--device", "cpu", "--sharded", "--data-axes", "pod,data"])


def test_synth_trace_matches_reference():
    from repro.launch import serve_vi as jserve_vi
    from repro_torch.launch import serve_vi

    assert serve_vi.synth_trace(2048, 128, 0) == jserve_vi.synth_trace(2048, 128, 0)


# -- parity with the JAX package's engine --------------------------------------


@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    """The reference's demo classifier (``appendix_c(m=4000)``, ``oavi:fast``,
    ``cap_terms=64``), saved with the JAX package and loaded into the port's
    registry."""
    from repro.launch import serve_vi as jserve_vi

    path = str(tmp_path_factory.mktemp("jclf") / "clf")
    ref = jserve_vi.demo_classifier(4000, 0.005, 0)
    ref.save(path)
    reg = ModelRegistry(device=CPU)
    return ref, reg.load("carried", path)


def test_engine_parity_with_reference_engine(carried):
    """Both packages' engines serve the same ``synth_trace`` payloads: the
    features agree within rtol 1e-5, atol 1e-6 (the carried-across transform
    tolerance of ``tests/test_torch_pipeline.py``), and the labels are equal
    where the reference's decision margin is at least 1e-5."""
    from repro.launch import serve_vi as jserve_vi
    from repro.serving import TransformEngine as JEngine
    from repro_torch.launch import serve_vi

    ref, entry = carried
    jeng = JEngine(ref.models)
    sizes = serve_vi.synth_trace(64, 128, 0)
    payloads = serve_vi.make_payloads(ref.scaler.transform, sizes, 0)
    jpayloads = jserve_vi.synth_trace(64, 128, 0)
    assert sizes == jpayloads
    for p in payloads:
        got = entry.transform(p, scaled=True)
        want = np.asarray(jeng.transform(p))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        scores = ref.svm.decision_function(want)
        top2 = np.sort(scores, axis=1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) >= 1e-5
        assert np.array_equal(entry.head(got)[clear], ref.head(want)[clear])
    assert entry.engine.stats["recompiles"] == 0


# -- chaos: each fault against a fault-free run, bit for bit --------------------


@pytest.fixture(scope="module")
def rengine():
    rng = np.random.default_rng(0)
    X = rng.uniform(0, 1, (600, 3)).astype(np.float32)
    X[:, 2] = np.clip(X[:, 0] * X[:, 1] + rng.normal(0, 0.01, 600), 0, 1)
    model = api.fit(X, "oavi:fast", psi=0.01, cap_terms=64, device=CPU)
    eng = TransformEngine([model], device=CPU, config=CFG)
    eng.warmup()
    return eng


def _q(rows, seed=1):
    return _queries(rows, seed=seed, n=3)


def _fault_free(rengine, reqs):
    bat = MicroBatcher(rengine, config=BatcherConfig(max_delay_ms=50.0))
    futs = [bat.submit(r) for r in reqs]
    bat.run_once()
    return [f.result() for f in futs]


def test_chaos_transient_fault_is_retried_bit_identical(rengine):
    reqs = [_q(4, 4), _q(6, 5), _q(3, 6)]
    expected = _fault_free(rengine, reqs)
    chaos.install(FaultPlan([Fault(site="engine.transform", at=1, action="raise_transient")]))
    bat = MicroBatcher(rengine, config=BatcherConfig(max_delay_ms=50.0, backoff_ms=0.1))
    futs = [bat.submit(r) for r in reqs]
    bat.run_once()
    chaos.uninstall()
    for f, e in zip(futs, expected):
        assert np.array_equal(f.result(), e)
    assert bat.stats["retries"] == 1 and bat.stats["batches"] == 1


def test_chaos_retry_exhaustion_fails_the_batch(rengine):
    chaos.install(FaultPlan([Fault(site="engine.transform", at=1, action="raise_transient",
                                   times=3)]))
    bat = MicroBatcher(rengine, config=BatcherConfig(max_retries=2, backoff_ms=0.1))
    fut = bat.submit(_q(4, 6))
    bat.run_once()
    with pytest.raises(TransientEngineError):
        fut.result()
    fut2 = bat.submit(_q(4, 7))  # the engine heals
    bat.run_once()
    assert np.array_equal(fut2.result(), rengine.transform(_q(4, 7)))


def test_chaos_poison_request_fails_alone(rengine):
    good = [_q(4, 9), _q(7, 10), _q(3, 11)]
    expected = _fault_free(rengine, good)
    poison = _q(5, 12)
    poison[0, 0] = chaos.POISON_SENTINEL
    chaos.install(FaultPlan([Fault(site="engine.transform", action="poison")]))
    bat = MicroBatcher(rengine, config=BatcherConfig(max_delay_ms=50.0))
    futs = [bat.submit(g) for g in good[:2]]
    bad = bat.submit(poison)
    futs.append(bat.submit(good[2]))
    bat.run_once()
    chaos.uninstall()
    with pytest.raises(PoisonRequestError):
        bad.result()
    for f, e in zip(futs, expected):
        assert np.array_equal(f.result(), e)  # innocent riders: bit-identical
    assert bat.stats["bisections"] >= 1 and bat.stats["isolated_failures"] == 1


def test_chaos_deadline_expires_queued_request(rengine):
    import time

    expected = _fault_free(rengine, [_q(4, 16)])
    bat = MicroBatcher(rengine, config=BatcherConfig(max_delay_ms=0.0))
    fut = bat.submit(_q(4, 15), deadline_ms=1.0)
    fut2 = bat.submit(_q(4, 16))
    time.sleep(0.01)
    bat.run_once()
    with pytest.raises(DeadlineExceeded):
        fut.result()
    assert bat.stats["deadline_expired"] == 1
    assert np.array_equal(fut2.result(), expected[0])


def test_chaos_activation_failure_keeps_serving_old_version(rengine):
    model = rengine.models[0]
    reg = ModelRegistry(device=CPU, warmup=False)
    reg.register("m", model, activate=True)
    staged = reg.register("m", model, activate=False)
    chaos.install(FaultPlan([Fault(site="registry.activate", at=1, action="raise")]))
    with pytest.raises(InjectedFault):
        reg.activate("m", staged.version)
    chaos.uninstall()
    assert reg.active_version("m") == 1
    reg.activate("m", staged.version)
    assert reg.active_version("m") == staged.version


def test_chaos_store_committed_truncation_is_detected(tmp_path):
    """``store.committed``: a fault truncating the committed checkpoint's
    largest leaf makes ``restore`` raise ``IntegrityError`` naming it."""
    from repro_torch.checkpoint import store

    rng = np.random.default_rng(0)
    tree = {"w": rng.normal(size=(64, 8)).astype(np.float32),
            "b": rng.normal(size=(8,)).astype(np.float32)}
    plan = chaos.install(FaultPlan([Fault(site="store.committed", at=1, action="truncate",
                                          truncate_to=40)]))
    d = str(tmp_path / "ckpt")
    store.save(d, 0, tree)
    chaos.uninstall()
    assert plan.fired == [{"site": "store.committed", "count": 1, "action": "truncate"}]
    with pytest.raises(IntegrityError, match="truncated"):
        store.restore(d, 0, tree)
    store.save(d, 1, tree)  # without a plan the next save verifies
    assert np.array_equal(store.restore(d, 1, tree)[0]["w"], tree["w"])


def test_chaos_shard_sites(tmp_path):
    """``shards.shard_written`` fires per shard file before the meta commit
    (opening the directory names the truncated shard) and
    ``shards.committed`` after ``meta.json`` (a truncated meta cannot be
    opened)."""
    from repro_torch.data.synthetic import write_shards
    from repro_torch.streaming.source import ShardDirSource

    X = np.random.default_rng(1).uniform(0, 1, (256, 4)).astype(np.float32)
    plan = chaos.install(FaultPlan([Fault(site="shards.shard_written", at=2,
                                          action="truncate", truncate_to=400)]))
    d = str(tmp_path / "torn")
    write_shards(d, X, shard_rows=64)
    chaos.uninstall()
    assert [f["count"] for f in plan.fired] == [2]
    with pytest.raises(IntegrityError, match="shard_00001.npy"):
        ShardDirSource(d)
    chaos.install(FaultPlan([Fault(site="shards.committed", at=1, action="truncate",
                                   truncate_to=10)]))
    d2 = str(tmp_path / "meta")
    write_shards(d2, X, shard_rows=64)
    chaos.uninstall()
    with pytest.raises(ValueError):
        ShardDirSource(d2)
