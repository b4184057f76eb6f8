"""The port's observability layer (``repro_torch.obs``) and the fits' timing
contract, on the CPU.

* The reference's ``tests/test_obs.py`` cases that touch no journal, on the
  port's ``obs``: span nesting, thread isolation, sampling, the disabled
  no-op, the sketch's quantiles, merge and moments, trace validation and the
  JSONL round trip.
* The metric sketches, their states and ``percentile_summary`` held equal to
  the reference's on the same seeded inputs (the port keeps its own copy).
* Every fit loop of the port (local, class-batched, streamed, online) keeps
  the timing contract and carries ``flops_per_degree`` (the analytic count
  of ``kernels.ops``), ``compile_seconds`` and ``achieved_gflops``; enabling
  obs changes no bit of a fit.
* Algorithm 2's spans (``core/pipeline.py``, ``core/svm.py``): the tree of
  one fit and its predict, one span a FISTA chunk and one a stop test, the
  pipeline's ``stats`` equal to its spans' durations and filled with obs
  off, and the classifier bit for bit the same with obs on and off.
* The ``tests/test_flight_recorder.py`` cases with a port counterpart:
  memory sampling, profiler windows, the SLO burn windows,
  ``baseline.check_regression`` and ``obs_report`` over torn tails.
"""

import json
import math
import os
import threading
import time

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro_torch import api, obs
from repro_torch.core import oavi, svm
from repro_torch.core.oavi import OAVIConfig
from repro_torch.core.pipeline import PipelineConfig, VanishingIdealClassifier
from repro_torch.core.transform import MinMaxScaler
from repro_torch.data.synthetic import appendix_c
from repro_torch.kernels import ops
from repro_torch.launch import obs_report
from repro_torch.obs import baseline, device, slo
from repro_torch.obs.metrics import Histogram, Registry


@pytest.fixture(autouse=True)
def _clean_obs(monkeypatch):
    """Each test starts from enabled, unsampled, empty recorder state."""
    monkeypatch.delenv("OBS_DEVICE", raising=False)
    monkeypatch.delenv("OBS_TORCH_PROFILE", raising=False)
    obs.configure(enabled=True, sample_every=1, torch_trace=False)
    obs.reset()
    yield
    obs.configure(enabled=True, sample_every=1, torch_trace=False)
    obs.reset()


def _span_events():
    return [e for e in obs.trace_events() if e["ph"] == "X"]


def _scaled(m, seed):
    X, _ = appendix_c(m=m, seed=seed)
    return MinMaxScaler(dtype="float32").fit_transform(X)


# ---------------------------------------------------------------------------
# spans: nesting, thread-safety, sampling


def test_span_nesting_stack():
    assert obs.current_stack() == []
    with obs.span("outer"):
        assert obs.current_stack() == ["outer"]
        with obs.span("inner", d=2):
            assert obs.current_stack() == ["outer", "inner"]
        assert obs.current_stack() == ["outer"]
    assert obs.current_stack() == []
    assert [e["name"] for e in _span_events()] == ["inner", "outer"]


def test_span_records_duration_and_args():
    with obs.span("work", rows=7) as sp:
        pass
    assert sp.duration_s >= 0.0
    (ev,) = _span_events()
    assert ev["name"] == "work" and ev["args"] == {"rows": 7} and ev["dur"] >= 0.0


def test_spans_are_thread_isolated():
    errors = []
    barrier = threading.Barrier(4)

    def worker(tag):
        try:
            barrier.wait(timeout=10)
            for i in range(50):
                with obs.span(f"{tag}/outer", i=i):
                    with obs.span(f"{tag}/inner"):
                        stack = obs.current_stack()
                        if stack != [f"{tag}/outer", f"{tag}/inner"]:
                            errors.append((tag, stack))
                if obs.current_stack():
                    errors.append((tag, "leak"))
        except Exception as exc:  # surfaced through errors
            errors.append((tag, repr(exc)))

    threads = [threading.Thread(target=worker, args=(f"t{k}",)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    events = _span_events()
    assert len(events) == 4 * 50 * 2
    by_tag = {}
    for e in events:
        by_tag.setdefault(e["name"].split("/")[0], set()).add(e["tid"])
    assert all(len(tids) == 1 for tids in by_tag.values())
    assert len(set().union(*by_tag.values())) == 4


def test_timed_is_a_recorded_span_while_enabled():
    with obs.timed("work", rows=7) as sp:
        assert obs.current_stack() == ["work"]
    (ev,) = _span_events()
    assert ev["args"] == {"rows": 7} and ev["dur"] == sp.duration_s * 1e6
    assert ev["ts"] == (sp.start - obs.epoch()) * 1e6


def test_timed_only_reads_the_clock_while_disabled():
    with obs.disabled():
        t_before = time.perf_counter()
        with obs.timed("work", rows=7) as sp:
            assert obs.current_stack() == []
        t_after = time.perf_counter()
    assert t_before <= sp.start and sp.start + sp.duration_s <= t_after
    assert obs.trace_events() == []


def test_epoch_puts_trace_times_on_the_host_clock():
    t_before = time.perf_counter()
    with obs.span("work"):
        pass
    t_after = time.perf_counter()
    (ev,) = _span_events()
    start = obs.epoch() + ev["ts"] * 1e-6
    assert t_before <= start <= start + ev["dur"] * 1e-6 <= t_after


def test_sampling_keeps_every_nth():
    obs.configure(sample_every=5)
    for _ in range(20):
        with obs.span("sampled"):
            pass
    assert len(_span_events()) == 4


def test_events_are_instant_records():
    obs.event("fit/regrowth", Lcap=128)
    (ev,) = obs.trace_events()
    assert ev["ph"] == "i" and ev["args"] == {"Lcap": 128}


def test_torch_trace_spans_reach_the_profiler():
    """``OBS_TORCH_TRACE``'s counterpart: each span is also a
    ``record_function`` range that ``torch.profiler`` sees."""
    from torch.profiler import ProfilerActivity, profile

    obs.configure(torch_trace=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("fit/degree", d=1):
            torch.ones(4) + 1
    assert "fit/degree" in {ev.key for ev in prof.key_averages()}
    assert [e["name"] for e in _span_events()] == ["fit/degree"]


# ---------------------------------------------------------------------------
# disabled: true no-ops, numerics unchanged


def test_disabled_span_is_noop_singleton():
    obs.disable()
    try:
        a = obs.span("x")
        b = obs.span("y", rows=3)
        assert a is b
        with a:
            assert obs.current_stack() == []
        obs.event("ignored")
        assert obs.trace_events() == []
    finally:
        obs.enable()


def test_disabled_context_restores_state():
    assert obs.enabled()
    with obs.disabled():
        assert not obs.enabled()
        with obs.disabled():
            assert not obs.enabled()
        assert not obs.enabled()
    assert obs.enabled()


def test_metrics_stay_live_when_disabled():
    c = obs.Counter()
    h = obs.Histogram()
    with obs.disabled():
        c.inc(3)
        h.observe(2.0)
    assert c.value == 3 and h.count == 1


def _same_model(a, b):
    assert a.book.terms == b.book.terms
    assert [g.term for g in a.generators] == [g.term for g in b.generators]
    for ga, gb in zip(a.generators, b.generators):
        assert np.array_equal(ga.coeffs, gb.coeffs) and ga.mse == gb.mse


@pytest.mark.parametrize("torch_trace", [False, True], ids=["spans", "spans+record_function"])
def test_fit_bit_identical_with_obs_on_and_off(torch_trace):
    X = _scaled(400, 0)
    cfg = OAVIConfig(psi=0.01, engine="fast")
    obs.configure(torch_trace=torch_trace)
    model_on = oavi.fit(X, cfg, device="cpu")
    assert {e["name"] for e in _span_events()} >= {"fit", "fit/degree"}
    with obs.disabled():
        model_off = oavi.fit(X, cfg, device="cpu")
    _same_model(model_on, model_off)
    assert model_off.stats["flops_per_degree"] == [None] * len(model_off.stats["degrees"])
    assert model_on.stats["flops_per_degree"] != model_off.stats["flops_per_degree"]


def _classifier(max_iter=100, tol=1e-4):
    X, y = appendix_c(m=800, seed=4)
    config = PipelineConfig(method="fast", psi=0.01,
                            svm=svm.LinearSVMConfig(max_iter=max_iter, tol=tol))
    clf = VanishingIdealClassifier(config, device="cpu").fit(X[:500], y[:500])
    return clf, clf.predict(X[500:])


@pytest.mark.parametrize("torch_trace", [False, True], ids=["spans", "spans+record_function"])
def test_classifier_bit_identical_with_obs_on_and_off(torch_trace):
    obs.configure(torch_trace=torch_trace)
    on, pred_on = _classifier()
    with obs.disabled():
        off, pred_off = _classifier()
    assert np.array_equal(on.svm.W, off.svm.W) and np.array_equal(on.svm.b, off.svm.b)
    assert on.svm.stats["iters"] == off.svm.stats["iters"]
    assert np.array_equal(pred_on, pred_off)


# parent of each span of a fit and its predict (the tree is by time: a span
# lies inside its parent's interval)
SPAN_TREE = {
    "pipeline/fit": None, "pipeline/generators": "pipeline/fit",
    "pipeline/scale": "pipeline/generators", "fit": "pipeline/generators",
    "fit/degree": "fit", "svm/fit": "pipeline/fit", "svm/upload": "svm/fit",
    "svm/power": "svm/fit", "svm/fista": "svm/fit", "svm/stop_test": "svm/fista",
    "svm/fista_block": "svm/fista", "svm/download": "svm/fit",
    "pipeline/predict": None, "svm/decision": "pipeline/predict",
}


def _inside(e, parent):
    return parent["ts"] <= e["ts"] and e["ts"] + e["dur"] <= parent["ts"] + parent["dur"]


def test_classifier_fit_and_predict_record_the_span_tree():
    clf, _ = _classifier()
    events = _span_events()
    assert {e["name"] for e in events} == set(SPAN_TREE) | {"pipeline/transform"}
    (top,) = [e for e in events if e["name"] == "pipeline/fit"]
    (pred,) = [e for e in events if e["name"] == "pipeline/predict"]
    assert top["args"] == pred["args"] == {"fit": clf.fit_id}
    assert top["ts"] + top["dur"] <= pred["ts"]
    for e in events:
        if e["name"] == "pipeline/transform":  # once in the fit, once in predict
            assert _inside(e, top) != _inside(e, pred)
            continue
        parent = SPAN_TREE[e["name"]]
        if parent is not None:
            assert any(_inside(e, p) for p in events if p["name"] == parent), e["name"]
    assert sum(_inside(e, pred) for e in events if e["name"] == "pipeline/transform") == 1
    clf2, _ = _classifier()
    assert clf2.fit_id == clf.fit_id + 1


@pytest.mark.parametrize("max_iter,tol", [(100, 1e-4), (64, 1e-4), (0, 1e-4), (10_000, 0.05)],
                         ids=["partial_chunk", "whole_chunks", "no_steps", "converged"])
def test_one_span_a_fista_chunk_and_one_a_stop_test(max_iter, tol):
    clf, _ = _classifier(max_iter=max_iter, tol=tol)
    iters = clf.svm.stats["iters"]
    assert iters <= max_iter and (iters < max_iter) == (max_iter == 10_000)
    names = [e["name"] for e in _span_events()]
    blocks = math.ceil(iters / svm.CHECK_EVERY)
    assert names.count("svm/fista_block") == blocks
    assert names.count("svm/stop_test") == blocks + 1


def test_pipeline_stats_are_their_spans_durations():
    clf, _ = _classifier()
    dur = {e["name"]: e["dur"] for e in _span_events()
           if e["name"] in ("pipeline/generators", "svm/fit", "pipeline/fit")}
    (transform, _) = [e["dur"] for e in _span_events() if e["name"] == "pipeline/transform"]
    s = clf.stats
    assert dur["pipeline/generators"] == s["time_generators"] * 1e6
    assert transform == s["time_transform"] * 1e6
    assert dur["svm/fit"] == s["time_svm"] * 1e6
    assert dur["pipeline/fit"] == s["time_total"] * 1e6
    assert s["time_generators"] + s["time_transform"] + s["time_svm"] <= s["time_total"]


def test_pipeline_stats_filled_and_nothing_recorded_with_obs_off():
    with obs.disabled():
        clf, _ = _classifier()
    s = clf.stats
    assert all(s[k] > 0 for k in ("time_generators", "time_transform", "time_svm", "time_total"))
    assert s["time_generators"] + s["time_transform"] + s["time_svm"] <= s["time_total"]
    assert obs.trace_events() == []


# ---------------------------------------------------------------------------
# histogram sketch: fidelity, merge algebra, summaries


@pytest.mark.parametrize(
    "sampler",
    [
        lambda rng: rng.lognormal(mean=0.0, sigma=1.5, size=50_000),
        lambda rng: rng.pareto(a=1.5, size=50_000) + 1.0,
    ],
    ids=["lognormal", "pareto"],
)
def test_sketch_quantiles_within_one_bucket(sampler):
    vals = sampler(np.random.default_rng(0))
    h = obs.Histogram()
    h.observe_many(vals)
    budget = obs.bucket_relative_error()
    for q in (50.0, 90.0, 99.0, 99.9):
        exact = float(np.percentile(vals, q))
        assert abs(h.quantile(q / 100.0) - exact) / exact <= budget


def test_histogram_exact_moments_and_underflow():
    vals = [0.5, 1.0, 2.0, 4.0, 8.0]
    h = obs.Histogram()
    h.observe_many(vals)
    assert (h.count, h.min, h.max) == (5, 0.5, 8.0)
    assert h.sum == pytest.approx(sum(vals)) and h.mean == pytest.approx(np.mean(vals))
    u = obs.Histogram()
    u.observe_many([-1.0, 0.0, 1.0])
    assert u.count == 3 and u.quantile(0.0) == 0.0 and u.quantile(1.0) >= 1.0


def test_histogram_merge_is_associative_and_exact():
    rng = np.random.default_rng(7)
    parts = [rng.lognormal(0.0, 1.0, 5000) for _ in range(3)]

    def sketch(chunks):
        h = obs.Histogram()
        for c in chunks:
            h.observe_many(c)
        return h

    left = sketch([parts[0]]).merge(sketch([parts[1]])).merge(sketch([parts[2]]))
    right = sketch([parts[0]]).merge(sketch([parts[1]]).merge(sketch([parts[2]])))
    whole = sketch(parts)
    for q in (0.5, 0.9, 0.99):
        assert left.quantile(q) == right.quantile(q) == whole.quantile(q)
    assert left.count == right.count == whole.count == 15000
    assert left.min == whole.min and left.max == whole.max


def test_histogram_summary_keys_and_empty():
    h = obs.Histogram()
    h.observe_many([1.0, 2.0, 3.0])
    assert set(h.summary()) == {"count", "sum", "mean", "min", "max", "p50", "p90", "p99",
                                "p999"}
    empty = Histogram()
    assert empty.quantile(0.99) is None and empty.summary()["count"] == 0
    assert Histogram().merge(Histogram()).quantile(0.5) is None


def test_registry_labels_and_snapshot():
    reg = obs.Registry()
    reg.counter("fit.regrowths", backend="local").inc()
    reg.counter("fit.regrowths", backend="class_batch").inc(2)
    reg.histogram("fit.seconds", backend="local").observe(0.5)
    by_key = {(r["name"], tuple(sorted(r["labels"].items()))): r for r in reg.snapshot()}
    assert by_key[("fit.regrowths", (("backend", "local"),))]["value"] == 1
    assert by_key[("fit.regrowths", (("backend", "class_batch"),))]["value"] == 2
    assert by_key[("fit.seconds", (("backend", "local"),))]["count"] == 1
    with pytest.raises(TypeError):
        reg.gauge("fit.seconds", backend="local")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sketches_equal_the_reference(seed):
    """The port's copy of the metric primitives gives the reference's
    summaries, sketch states, merges, registry snapshots and
    ``percentile_summary`` on the same seeded samples."""
    rng = np.random.default_rng(seed)
    vals = np.concatenate([rng.lognormal(-5.0, 1.2, 3000), [0.0, -1.0],
                           rng.pareto(1.5, 500) + 1.0])
    a, b = obs.Histogram(), jobs.Histogram()
    a.observe_many(vals[:2000])
    b.observe_many(vals[:2000])
    a2, b2 = obs.Histogram(), jobs.Histogram()
    a2.observe_many(vals[2000:])
    b2.observe_many(vals[2000:])
    a.merge(a2)
    b.merge(b2)
    assert a.summary() == b.summary()
    assert a.to_state() == b.to_state()
    for q in np.linspace(0.0, 1.0, 21):
        assert a.quantile(q) == b.quantile(q)
    for t in (0.001, 0.01, 1.0, 10.0):
        assert a.count_above(t) == b.count_above(t)
    assert obs.percentile_summary(vals, unit_scale=1e3) == jobs.percentile_summary(
        vals, unit_scale=1e3)
    assert obs.percentile_summary([]) is jobs.percentile_summary([]) is None
    ra, rb = obs.Registry(), jobs.Registry()
    for reg in (ra, rb):
        reg.counter("c", kind="x").inc(3)
        reg.gauge("g").set_max(2.5)
        reg.histogram("h", backend="local").observe_many(vals[:100])
    assert ra.snapshot() == rb.snapshot()
    assert ra.percentile_summary("h") == rb.percentile_summary("h")
    assert Histogram.from_state(b.to_state()).summary() == b.summary()


# ---------------------------------------------------------------------------
# trace export: Chrome-trace schema


def test_export_trace_validates_against_schema(tmp_path):
    with obs.span("fit", m=100):
        with obs.span("fit/degree", d=2):
            pass
    obs.event("fit/regrowth", Lcap=128)
    path = obs.export_trace(str(tmp_path / "trace.json"))
    with open(path) as f:
        doc = json.load(f)
    payload = obs.validate_chrome_trace(doc)
    assert doc["displayTimeUnit"] == "ms"
    assert {e["name"] for e in payload} == {"fit", "fit/degree", "fit/regrowth"}
    meta = [e for e in doc["traceEvents"] if e["ph"] == "M"]
    assert any(e["name"] == "process_name" for e in meta)
    assert any(e["name"] == "thread_name" for e in meta)
    assert all(e["pid"] == os.getpid() for e in payload)
    jobs.validate_chrome_trace(doc)  # the reference's validator accepts it too


@pytest.mark.parametrize(
    "doc",
    [
        [],
        {"events": []},
        {"traceEvents": [{"ph": "X"}]},
        {"traceEvents": [{"name": "x", "ph": "Z", "ts": 0, "pid": 1, "tid": 1}]},
        {"traceEvents": [{"name": "x", "ph": "X", "ts": 0, "pid": 1, "tid": 1}]},
    ],
    ids=["not-dict", "wrong-key", "missing-keys", "bad-phase", "x-without-dur"],
)
def test_validate_chrome_trace_rejects_malformed(doc):
    with pytest.raises(ValueError):
        obs.validate_chrome_trace(doc)


def test_trace_buffer_bounded_with_drop_count():
    obs.configure(trace_capacity=16)
    try:
        for i in range(40):
            obs.event("tick", i=i)
        snap = obs.snapshot()
        assert snap["trace"]["events"] == 16 and snap["trace"]["dropped"] == 24
        assert [e["args"]["i"] for e in obs.trace_events()] == list(range(24, 40))
    finally:
        obs.configure(trace_capacity=100_000)


def test_metrics_export_jsonl_roundtrip(tmp_path):
    obs.registry().counter("checkpoint.saves").inc(2)
    obs.registry().histogram("fit.seconds", backend="local").observe(1.5)
    path = obs.export_metrics(str(tmp_path / "metrics.jsonl"))
    rows = [json.loads(line) for line in open(path)]
    assert {"checkpoint.saves", "fit.seconds"} <= {r["name"] for r in rows}
    assert rows == obs.registry().snapshot()


def test_merge_traces_two_processes_with_markers():
    def doc(pid, name):
        return {"traceEvents": [
            {"name": "process_name", "ph": "M", "ts": 0, "pid": pid, "tid": 0,
             "args": {"name": name}},
            {"name": "update", "ph": "X", "ts": 10.0, "dur": 5.0, "pid": pid, "tid": 1,
             "args": {}},
        ]}

    docs = [doc(100, "killed"), doc(100, "resumed")]
    markers = [{"name": "chaos/sigkill", "after_doc": 0, "args": {}}]
    merged = obs.merge_traces(docs, markers=markers)
    obs.validate_chrome_trace(merged)
    spans = [e for e in merged["traceEvents"] if e.get("ph") == "X"]
    assert len({e["pid"] for e in spans}) == 2
    ref = jobs.merge_traces(docs, markers=markers)
    assert [e for e in merged["traceEvents"] if e["ph"] != "M" and e["name"] != "chaos/sigkill"] \
        == [e for e in ref["traceEvents"] if e["ph"] != "M" and e["name"] != "chaos/sigkill"]


# ---------------------------------------------------------------------------
# fit timing contract, device fields, analytic flops


def _assert_timing_contract(stats):
    total = stats["time_total"]
    parts = (stats["time_setup"] + stats["time_degrees"] + stats["time_finalize"]
             + stats["time_unattributed"])
    assert total == pytest.approx(parts, abs=1e-9)
    assert stats["time_setup"] >= 0.0 and stats["time_degrees"] >= 0.0
    assert stats["time_finalize"] >= 0.0
    assert sum(stats["degree_times"]) == pytest.approx(
        stats["time_degrees"], abs=1e-6 * max(1, len(stats["degree_times"])))
    assert len(stats["flops_per_degree"]) == len(stats["degree_times"])
    assert all(f > 0 for f in stats["flops_per_degree"])
    assert stats["compile_seconds"] == 0.0  # no kernel builds off the card
    assert stats["achieved_gflops"] > 0


def _fit_local(X):
    return [oavi.fit(X, OAVIConfig(psi=0.01), device="cpu")]


def _fit_class_batch(X):
    return api.fit_classes([X[:300], X[300:]], "oavi:fast", psi=0.01, device="cpu")


def _fit_streamed(X):
    return [api.fit(X, "oavi:fast", psi=0.01, chunk_rows=256, device="cpu")]


def _fit_streamed_classes(X):
    return api.fit_classes([X[:300], X[300:]], "oavi:fast", psi=0.01, chunk_rows=256,
                           device="cpu")


def _fit_online(X):
    model = api.fit(X[:400], "oavi:fast", psi=0.01, chunk_rows=256, capture_state=True,
                    device="cpu")
    return [model, api.update(model, model.fit_state, X, device="cpu").model]


@pytest.mark.parametrize("fit", [_fit_local, _fit_class_batch, _fit_streamed,
                                 _fit_streamed_classes, _fit_online],
                         ids=["local", "class_batch", "streaming", "streaming_class_batch",
                              "online"])
def test_fit_stats_timing_contract(fit):
    X = _scaled(600, 2)
    models = fit(X)
    for m in models:
        _assert_timing_contract(m.stats)
        assert m.stats["num_G"] == m.num_G and m.stats["Lcap_final"] >= m.num_O
    if len(models) == 2 and "class_batch" in models[0].stats:
        # one group, one set of timing fields shared to the bit
        keys = ("time_total", "time_setup", "time_degrees", "degree_times",
                "flops_per_degree", "kernel_launches")
        assert all(models[0].stats[k] == models[1].stats[k] for k in keys)
    names = {e["name"] for e in _span_events()}
    assert {"fit", "fit/degree"} <= names
    backends = {r["labels"].get("backend") for r in obs.registry().snapshot()
                if r["name"] == "fit.seconds"}
    assert backends & {"local", "class_batch", "streaming", "streaming_class_batch",
                       "online"}


def test_fit_regrowth_is_counted_and_traced():
    X = _scaled(600, 3)
    model = oavi.fit(X, OAVIConfig(psi=0.005, cap_terms=4, cap_border=4), device="cpu")
    assert model.stats["regrowths"] >= 1
    regrowths = [e for e in obs.trace_events() if e["name"] == "fit/regrowth"]
    assert len(regrowths) == model.stats["regrowths"]
    (row,) = [r for r in obs.registry().snapshot() if r["name"] == "fit.regrowths"]
    assert row["value"] == model.stats["regrowths"]


def test_flops_per_degree_is_the_analytic_count(monkeypatch):
    """Each degree's work is the Gram op's formula at its shapes plus the
    candidate loop's formula on its decisions (``chip_smoke.py``'s
    ``gram_work`` and ``degree_work``), recomputed here from what the fit
    handed the ops."""
    shapes, decisions = [], []
    gram = ops.gram_accumulate
    collect = oavi.collect_degree

    def rec_gram(A, X, parents, vars_, acc=None, **kw):
        shapes.append((A.shape[0], A.shape[1], parents.shape[0]))
        return gram(A, X, parents, vars_, acc, **kw)

    def rec_collect(book, border, accepted, mses, coeffs, generators):
        decisions.append((len(book), np.asarray(accepted[: len(border)])))
        return collect(book, border, accepted, mses, coeffs, generators)

    monkeypatch.setattr(ops, "gram_accumulate", rec_gram)
    monkeypatch.setattr(oavi, "collect_degree", rec_collect)
    X = _scaled(700, 4)
    model = oavi.fit(X, OAVIConfig(psi=0.005), device="cpu")
    want = [ops.gram_flops(m, L, K) + ops.ihb_degree_flops(acc, ell0)
            for (m, L, K), (ell0, acc) in zip(shapes, decisions)]
    assert model.stats["flops_per_degree"] == want
    assert shapes[0] == (768, 64, 64)  # 700 rows padded to the 256-row Gram block
    m, L, K = shapes[0]
    assert ops.gram_flops(m, L, K) == m * K + 2.0 * m * L * K + m * K * (K + 1)


def test_op_flops_same_with_use_kernel_false():
    rng = np.random.default_rng(0)
    A = torch.from_numpy(rng.uniform(0, 1, (300, 8)).astype(np.float32))
    X = torch.from_numpy(rng.uniform(0, 1, (300, 3)).astype(np.float32))
    p = torch.tensor([0, 1, 2, 3])
    v = torch.tensor([0, 1, 2, 0])
    for kw in ({}, {"use_kernel": False}):
        f0 = ops.flop_count()
        ops.gram_accumulate(A, X, p, v, **kw)
        assert ops.flop_count() - f0 == ops.gram_flops(512, 8, 4)
        f0 = ops.flop_count()
        ops.gram_update(A, X, p, v, **kw)
        assert ops.flop_count() - f0 == ops.gram_flops(300, 8, 4)
        f0 = ops.flop_count()
        ops.gram_accumulate_batched(A[None].repeat(2, 1, 1), X[None].repeat(2, 1, 1),
                                    p[None].repeat(2, 1), v[None].repeat(2, 1), **kw)
        assert ops.flop_count() - f0 == 2 * ops.gram_flops(512, 8, 4)
    # candidate a with ell_a columns: 2 l^2 + 3 l - ell0, plus 3 l^2 + 2 l + 1
    # for an append; ell grows by one per append
    acc = np.array([False, True, False])
    assert ops.ihb_degree_flops(acc, 5) == (
        (2 * 25 + 15 - 5) + (3 * 25 + 10 + 1)
        + (2 * 36 + 18 - 5)
        + (2 * 36 + 18 - 5) + (3 * 36 + 12 + 1))
    assert ops.ihb_degree_flops(np.zeros(0, bool), 5) == 0.0


def test_fit_stats_carry_device_fields_and_aggregate_gauges():
    """The reference's device fields, and ``aggregate_fit_stats``'s registry
    mirror (``fit.solver_schedule_len``, ``fit.class_batch_padding_waste``)."""
    rng = np.random.default_rng(0)
    Xs = [rng.uniform(0, 1, (40 + 13 * i, 3)) for i in range(3)]
    models = api.fit_classes(Xs, "oavi:bpcgavi", psi=0.1, max_degree=2, device="cpu")
    for m in models:
        for key in ("flops_per_degree", "compile_seconds", "achieved_gflops",
                    "solver_schedule_len", "solver_escalations", "class_batch_padding"):
            assert key in m.stats
    agg = api.aggregate_fit_stats(models)
    assert isinstance(agg["solver_schedule_len"], int)
    named = {(r["name"], tuple(sorted(r["labels"].items()))) for r in obs.registry().snapshot()}
    assert ("fit.solver_schedule_len", (("backend", "aggregate"),)) in named
    assert ("fit.class_batch_padding_waste", ()) in named


# ---------------------------------------------------------------------------
# device: build windows, memory sampling, profiler windows


def test_compile_window_reads_kernel_builds():
    with device.CompileWindow() as cw:
        pass
    assert cw.seconds == 0.0 and cw.count == 0
    s0, c0 = device.compile_snapshot()
    with device.CompileWindow() as cw:
        device.add_build_seconds(0.25)
    assert cw.count == 1 and cw.seconds == pytest.approx(0.25)
    assert device.compile_snapshot()[1] == c0 + 1
    assert [e for e in obs.trace_events() if e["name"] == "device/kernel_build"]


def test_sample_memory_off_the_card_is_empty():
    """On the CPU the port reports what the reference reports on a backend
    without allocator statistics: no sample, stats untouched."""
    stats = {}
    assert device.sample_memory(stats, device="cpu") == {}
    assert stats == {}
    assert device.device_memory_stats("cpu") == {} and device.live_buffer_bytes("cpu") is None
    model = oavi.fit(_scaled(300, 5), OAVIConfig(psi=0.01), device="cpu")
    assert "peak_bytes" not in model.stats and "peak_bytes_start" not in model.stats


def test_profile_window_noop_without_env():
    w = device.profile_window("test")
    assert w is device._NOOP_WINDOW
    with w:
        pass
    assert not [e for e in obs.trace_events() if e["name"] == "device/profile_start"]


def test_profile_window_captures_and_nests(tmp_path, monkeypatch):
    monkeypatch.setenv("OBS_TORCH_PROFILE", str(tmp_path))
    with device.profile_window("fit/local") as outer:
        with device.profile_window("inner") as inner:
            torch.ones(8) * 2
    assert inner.path is None and inner.prof is None  # nested: a no-op
    assert outer.path and os.path.exists(outer.path)
    with open(outer.path) as f:
        assert "traceEvents" in json.load(f)
    busy_s, by_kernel = device.profile_kernels(outer.prof)
    assert busy_s == 0.0 and by_kernel == {}  # no card here
    names = [e["name"] for e in obs.trace_events()]
    assert names.count("device/profile_start") == 1 and "device/profile_stop" in names


# ---------------------------------------------------------------------------
# SLO burn windows, the regression baseline, obs_report


def _slo_windows():
    return (slo.BurnWindow(long_s=60.0, short_s=5.0, max_burn=10.0),)


def test_error_objective_alerts_and_recovers():
    reg = Registry()
    bad = reg.counter("serve.failures")
    total = reg.counter("serve.requests")
    mon = slo.SLOMonitor(
        [slo.error_objective("errs", "serve.failures", "serve.requests", budget_frac=0.01)],
        windows=_slo_windows(), registry=reg, now=lambda: 0.0)
    assert mon.tick(now=0.0) == []
    total.inc(100)
    bad.inc(50)
    alerts = mon.tick(now=1.0)
    assert len(alerts) == 1 and alerts[0]["burn"] >= 10.0 and mon.alerting()
    total.inc(400)
    assert mon.tick(now=10.0) == [] and not mon.alerting()
    assert mon.state()["ticks"] == 3
    json.dumps(mon.state())


def test_latency_objective_counts_samples_above_threshold():
    reg = Registry()
    h = reg.histogram("serve.transform_seconds", backend="local")
    mon = slo.SLOMonitor(
        [slo.latency_objective("lat", "serve.transform_seconds", threshold_s=0.1,
                               budget_frac=0.01, backend="local")],
        windows=_slo_windows(), registry=reg, now=lambda: 0.0)
    mon.tick(now=0.0)
    h.observe_many([0.001] * 90 + [0.5] * 10)
    assert mon.tick(now=1.0) and mon.alerting()
    obj = mon.state()["objectives"][0]
    assert (obj["total"], obj["bad"]) == (100, 10)
    with pytest.raises(ValueError):
        slo.latency_objective("x", "m", threshold_s=0.1, budget_frac=0.0)
    with pytest.raises(ValueError):
        slo.SLOMonitor([])


def _record(metrics=None, sketches=None):
    return {"schema": baseline.RECORD_SCHEMA, "metrics": metrics or {},
            "sketches": sketches or {}}


def test_check_regression_passes_unchanged_and_fails_2x():
    key = "serve/rows/0:t_s"
    base = [_record({key: 1.0}), _record({key: 1.05})]
    ok = baseline.check_regression(_record({key: 1.02}), base)
    assert ok["status"] == "pass" and ok["checked"] == 1 and not ok["findings"]
    bad = baseline.check_regression(_record({key: 2.0}), base)
    assert bad["status"] == "fail"
    (finding,) = bad["findings"]
    assert finding["key"] == key and finding["ratio"] == pytest.approx(2.0)

    def sketch(scale):
        h = Histogram()
        for i in range(200):
            h.observe(scale * (0.05 + 0.001 * (i % 10)))
        return h.to_state()

    series = "serve.transform_seconds{backend=local}"
    sbase = [_record(sketches={series: sketch(1.0)})] * 2
    assert baseline.check_regression(_record(sketches={series: sketch(1.02)}),
                                     sbase)["status"] == "pass"
    assert baseline.check_regression(_record(sketches={series: sketch(2.0)}),
                                     sbase)["status"] == "fail"


def test_load_history_tolerates_torn_tail(tmp_path):
    p = tmp_path / "history.jsonl"
    p.write_text(json.dumps(_record({"a:t_s": 1.0})) + "\n"
                 + json.dumps(_record({"a:t_s": 1.1})) + "\n"
                 + '{"schema": "bench-history.v1", "metr')
    records, warnings = baseline.load_history(str(p))
    assert len(records) == 2 and any("torn tail" in w for w in warnings)
    p.write_text('{"not json\n' + json.dumps(_record()) + "\n")
    with pytest.raises(ValueError, match="mid-file"):
        baseline.load_history(str(p))


def test_report_tolerates_torn_metrics_tail(tmp_path):
    p = tmp_path / "metrics.jsonl"
    p.write_text(json.dumps({"name": "a", "labels": {}, "type": "counter", "value": 1})
                 + "\n" + '{"name": "b", "ty')
    rows, warnings = obs_report.load_metric_rows(str(p))
    assert [r["name"] for r in rows] == ["a"]
    assert any("torn tail" in w for w in warnings)
    lines = obs_report.report(str(tmp_path))
    assert any("torn tail" in ln for ln in lines) and any(ln.startswith("a ") for ln in lines)
    p.write_text('{"broken\n' + json.dumps({"name": "a", "type": "counter", "value": 1})
                 + "\n")
    with pytest.raises(ValueError, match="corrupt"):
        obs_report.load_metric_rows(str(p))


def test_report_over_a_fit_export(tmp_path, capsys):
    """A fit's exported metrics and trace render, as text and as JSON."""
    oavi.fit(_scaled(300, 6), OAVIConfig(psi=0.01), device="cpu")
    obs.export_metrics(str(tmp_path / "metrics.jsonl"))
    obs.export_trace(str(tmp_path / "trace.json"))
    lines = obs_report.main(["--obs-dir", str(tmp_path)])
    assert any(ln.startswith("fit.seconds{backend=local}") for ln in lines)
    assert any("span  fit/degree" in ln for ln in lines)
    capsys.readouterr()
    obs_report.main(["--obs-dir", str(tmp_path), "--format", "json"])
    payload = json.loads(capsys.readouterr().out)
    assert payload["trace"]["spans"]["fit"]["n"] == 1
    assert payload["slo"] is None
    assert math.isfinite(payload["trace"]["spans"]["fit/degree"]["total_s"])
