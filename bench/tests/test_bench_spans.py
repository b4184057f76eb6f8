"""The program's spans in a run (``bench/harness/spans.py``) and the
per-layer metrics that read them, on synthetic spans and device activity,
and on a small classify fit on the CPU."""

import math

import pytest

from bench.harness import spans
from bench.harness.runner import RunData
from bench.harness.spec import reader


def _x(name, ts_us, dur_us, **args):
    return {"name": name, "ph": "X", "ts": ts_us, "dur": dur_us, "pid": 1, "tid": 1,
            "args": args}


# one fit (fit=3) on the trace's clock, in microseconds: generators 0-100 with
# its class fit at 20-80, transform 100-110, the SVM 110-200 with FISTA at
# 130-190 (a stop test 130-140, a block 140-170, the last stop test 170-190),
# then predict 210-260 (transform 210-240, decision 240-260)
FIT = [
    _x("pipeline/fit", 0, 205, fit=3), _x("pipeline/generators", 0, 100),
    _x("pipeline/scale", 0, 10), _x("fit", 20, 60), _x("fit/degree", 30, 40),
    _x("pipeline/transform", 100, 10), _x("svm/fit", 110, 90), _x("svm/fista", 130, 60),
    _x("svm/stop_test", 130, 10), _x("svm/fista_block", 140, 30), _x("svm/stop_test", 170, 20),
    _x("pipeline/predict", 210, 50, fit=3), _x("pipeline/transform", 210, 30),
    _x("svm/decision", 240, 20),
]
STATS = {"time_generators": 100e-6, "time_transform": 10e-6, "time_svm": 90e-6,
         "svm_iters": 40}
EPOCH = 1000.0


def test_program_spans_are_put_on_the_host_clock_through_the_epoch():
    got = spans.program_spans(FIT + [{"name": "i", "ph": "i", "ts": 5, "pid": 1, "tid": 1}],
                              EPOCH)
    assert len(got) == len(FIT)
    first = got[0]
    assert first.name == "pipeline/fit" and first.args == {"fit": 3}
    assert first.start == EPOCH and math.isclose(first.end, EPOCH + 205e-6)
    assert first.seconds == 205e-6
    assert [s.start for s in got] == sorted(s.start for s in got)
    # outer spans first where two start together
    assert [s.name for s in got[:3]] == ["pipeline/fit", "pipeline/generators",
                                        "pipeline/scale"]


def test_a_fit_holds_its_predict_and_the_spans_inside_them():
    groups = spans.by_fit(spans.program_spans(FIT, EPOCH))
    assert list(groups) == [3]
    assert sorted(s.name for s in groups[3]) == sorted(e["name"] for e in FIT)


def test_self_seconds_leave_out_the_child_spans():
    ss = spans.program_spans(FIT, EPOCH)
    assert math.isclose(spans.self_seconds(ss, "pipeline/generators", "fit"), 40e-6, abs_tol=1e-12)
    assert math.isclose(spans.seconds(ss, "svm/stop_test"), 30e-6)
    assert spans.self_seconds(ss, "svm/fit", "no_such_child") == spans.seconds(ss, "svm/fit")


# device activity, microseconds from the epoch: two overlapping kernels
# inside the block, one straddling the block's end and the stop test's
# start, one inside the class fit
ACTS = [("k1", 145, 150), ("k2", 148, 160), ("k3", 165, 175), ("gram", 30, 70)]


def _busy():
    return spans.Busy([(n, EPOCH + s * 1e-6, EPOCH + e * 1e-6) for n, s, e in ACTS])


def test_busy_merges_activity_and_counts_starts():
    busy = _busy()
    assert len(busy.starts) == 3  # k1 and k2 merge
    assert math.isclose(busy.within(EPOCH + 140e-6, EPOCH + 170e-6), 20e-6, abs_tol=1e-12)
    assert math.isclose(busy.within(EPOCH, EPOCH + 1.0), 65e-6, abs_tol=1e-12)
    assert busy.within(EPOCH + 80e-6, EPOCH + 140e-6) == 0.0
    assert busy.count(EPOCH + 140e-6, EPOCH + 170e-6) == 3


def test_layers_count_the_activities_starting_inside_and_the_idle_time():
    rows = spans.layers(spans.program_spans(FIT, EPOCH), _busy())
    block, fista, stop = rows["svm/fista_block"], rows["svm/fista"], rows["svm/stop_test"]
    assert block["activities"] == 3 and fista["activities"] == 3 and stop["activities"] == 0
    assert math.isclose(block["idle_s"], 10e-6, abs_tol=1e-12)
    assert math.isclose(fista["idle_s"], 35e-6, abs_tol=1e-12)
    assert math.isclose(stop["idle_s"], 25e-6, abs_tol=1e-12)  # k3 runs into the stop test
    assert math.isclose(rows["svm/fista"]["seconds"], 60e-6)
    assert rows["fit"]["activities"] == 1 and math.isclose(rows["fit"]["idle_s"], 20e-6,
                                                           abs_tol=1e-12)


def test_idle_time_goes_to_the_innermost_span_and_the_rest_between():
    ss = spans.program_spans(FIT, EPOCH)
    idle = spans.idle_by_leaf(ss, _busy(), EPOCH - 10e-6, EPOCH + 270e-6)
    total = 280e-6 - 65e-6
    assert math.isclose(sum(idle.values()), total, abs_tol=1e-12)
    # fit/degree is busy throughout: no idle time of its own
    expect = {"pipeline/scale": 10e-6, "pipeline/generators": 30e-6, "fit": 20e-6,
              "pipeline/transform": 40e-6, "svm/fit": 30e-6, "svm/stop_test": 25e-6,
              "svm/fista_block": 10e-6, "pipeline/fit": 5e-6, "svm/decision": 20e-6,
              "between": 25e-6}
    assert set(idle) == set(expect)
    for k, v in expect.items():
        assert math.isclose(idle[k], v, abs_tol=1e-12), k


def test_leaves_cut_a_span_that_outlives_its_parent():
    ss = spans.program_spans([_x("a", 0, 10), _x("b", 5, 20)], 0.0)
    assert [(n, round(e - s, 9)) for s, e, n in spans.leaves(ss, 0.0, 30e-6)] == [
        ("a", 5e-6), ("b", 5e-6), (None, 20e-6)]


READERS = {"fista_step_us": 60e-6 / 40 * 1e6, "fista_enqueue_us": 30e-6 / 40 * 1e6,
           "generators_host_s": 40e-6, "predict_s": 50e-6}


def _run(stats):
    return RunData([dict(s) for s in stats], 1.0, None, {})


@pytest.mark.parametrize("name", sorted(READERS))
def test_each_reader_reads_the_traced_fits_spans(name, monkeypatch):
    from repro_torch import obs

    # the window's fit (fit=3) among the warm fit's (fit=2, other durations)
    warm = [dict(e, ts=e["ts"] + 1000) for e in FIT]
    for e in warm:
        if "fit" in e["args"]:
            e["args"] = {"fit": 2}
        if e["name"] == "svm/fit":
            e["dur"] = 80
    monkeypatch.setattr(obs, "trace_events", lambda: warm + FIT)
    # the spans' host-clock times are the epoch plus their microseconds; the
    # process's own epoch is the machine's uptime, and past ~16,000 s a double
    # holds those times coarser than the tolerance, so they get a fixed one
    monkeypatch.setattr(obs, "epoch", lambda: EPOCH)
    got = reader(name).read(_run([STATS]))
    assert math.isclose(got, READERS[name], rel_tol=1e-9, abs_tol=1e-12)


@pytest.mark.parametrize("name", sorted(READERS))
def test_each_reader_reads_none_without_the_spans(name, monkeypatch):
    from repro_torch import obs

    # a program without pipeline spans: FitScope's alone
    monkeypatch.setattr(obs, "trace_events", lambda: [e for e in FIT if e["name"] in
                                                      ("fit", "fit/degree")])
    assert reader(name).read(_run([STATS])) is None
    # with spans, but a fit of the run that none of them matches
    monkeypatch.setattr(obs, "trace_events", lambda: FIT)
    assert reader(name).read(_run([STATS, dict(STATS, time_svm=1.0)])) is None


def test_readers_find_a_small_classify_fit_on_the_cpu(small_config, cell_spec):
    """The classify entry's fits on the CPU, their stats as the runner keeps
    them: every reader finds the fits' spans, and they agree with the
    stats."""
    from bench.harness import spec as spec_mod
    from bench.harness.traffic import make_inputs
    from repro_torch import obs

    name = "appendix_c-2m.classify"
    spec, _ = cell_spec(name)
    cfg = small_config(name)
    entry = spec_mod.entry(spec_mod.traffic("classify")["entry"])
    obs.reset(metrics=False)
    st = entry.prepare(cfg, spec_mod.traffic("classify"), make_inputs(cfg["dataset"], 7), "cpu")
    entry.warm(st)
    stats = [entry.stats(entry.run(st)) for _ in range(2)]
    run = _run(stats)
    fits = spans.traced_fits(run)
    assert fits is not None and len(fits) == 2
    for f, s in zip(fits, stats):
        assert math.isclose(spans.seconds(f, "svm/fit"), s["time_svm"], abs_tol=1e-9)
        assert spans.seconds(f, "svm/fista_block") < spans.seconds(f, "svm/fista")
    values = {n: reader(n).read(run) for n in READERS}
    assert all(v is not None and v > 0 for v in values.values()), values
    assert values["fista_enqueue_us"] < values["fista_step_us"]
    assert values["generators_host_s"] < run.mean("time_generators")
