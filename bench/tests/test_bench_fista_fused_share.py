"""``fista_fused_share``: the fused FISTA steps of the traced fits' blocks
over their steps, read from synthetic spans and from a small classify fit on
the CPU (whose head takes the eager step: 0%)."""

import math

import pytest

from bench.harness.runner import RunData
from bench.harness.spec import reader

STATS = {"time_generators": 100e-6, "time_transform": 10e-6, "time_svm": 90e-6,
         "svm_iters": 40}


def _x(name, ts_us, dur_us, **args):
    return {"name": name, "ph": "X", "ts": ts_us, "dur": dur_us, "pid": 1, "tid": 1,
            "args": args}


def _fit(*blocks):
    """One fit (fit=3) whose FISTA issues ``blocks``: each a dict of the
    block span's args."""
    out = [_x("pipeline/fit", 0, 205, fit=3), _x("pipeline/generators", 0, 100),
           _x("fit", 20, 60), _x("pipeline/transform", 100, 10), _x("svm/fit", 110, 90),
           _x("svm/fista", 130, 60)]
    for n, args in enumerate(blocks):
        out.append(_x("svm/fista_block", 140 + 10 * n, 5, **args))
    return out + [_x("pipeline/predict", 210, 50, fit=3)]


def _read(monkeypatch, events, stats=(STATS,)):
    from repro_torch import obs

    monkeypatch.setattr(obs, "trace_events", lambda: events)
    return reader("fista_fused_share").read(RunData([dict(s) for s in stats], 1.0, None, {}))


@pytest.mark.parametrize("blocks,share", [
    ([{"fused": 32}, {"fused": 8}], 100.0),
    ([{"fused": 0}, {"fused": 0}], 0.0),
    ([{"fused": 32}, {"fused": 0}], 80.0),
])
def test_reads_the_fused_steps_over_the_steps(monkeypatch, blocks, share):
    assert math.isclose(_read(monkeypatch, _fit(*blocks)), share, abs_tol=1e-12)


@pytest.mark.parametrize("blocks", [[{}, {}], [{"fused": 32}, {}], []],
                         ids=["no_arg", "one_without", "no_blocks"])
def test_reads_none_where_the_blocks_carry_no_arg(monkeypatch, blocks):
    assert _read(monkeypatch, _fit(*blocks)) is None


def test_reads_none_without_the_fits_spans(monkeypatch):
    assert _read(monkeypatch, [e for e in _fit({"fused": 40}) if e["name"] == "fit"]) is None


def test_a_small_classify_fit_on_the_cpu_reads_zero(small_config, cell_spec):
    from bench.harness import spec as spec_mod
    from bench.harness.traffic import make_inputs
    from repro_torch import obs

    name = "appendix_c-2m.classify"
    cfg = small_config(name)
    entry = spec_mod.entry(spec_mod.traffic("classify")["entry"])
    obs.reset(metrics=False)
    st = entry.prepare(cfg, spec_mod.traffic("classify"), make_inputs(cfg["dataset"], 11), "cpu")
    stats = [entry.stats(entry.run(st))]
    assert reader("fista_fused_share").read(RunData(stats, 1.0, None, {})) == 0.0
