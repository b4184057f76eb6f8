"""The yardstick's arithmetic on fixed inputs: work counts, roofline
shares, the trace reduction and the comparison with limits."""

import math

import numpy as np
import pytest

from bench.harness import host, judge, trace, work


def test_gram_counts_the_needed_work():
    # m=512 rows, L=4 terms, K=6 candidates, n=3: B (m K), QL (2 m L K),
    # C's upper triangle (m K (K+1))
    flops, nbytes = work.gram(512, 4, 6, 3)
    assert flops == 512 * 6 + 2 * 512 * 4 * 6 + 512 * 6 * 7
    assert nbytes == 4 * (512 * 4 + 512 * 3) + 16 * 6 + 4 * (4 * 6 + 36)


def test_candidate_loop_counts_each_decision():
    # ell0 = 4; accepted, appended, accepted: ells 4, 4, 5
    flops, nbytes = work.candidate_loop([True, False, True], 4)
    ells = np.array([4.0, 4.0, 5.0])
    want = np.sum(2 * ells ** 2 + 3 * ells - 4) + (3 * 16 + 8 + 1)
    assert flops == want
    assert nbytes == 4 * (np.sum(2 * ells - 4) + 3 + 16 + 25 + 15 + 3) + 24 + 3 + 4
    assert work.candidate_loop([], 7) == (0.0, 0.0)


def test_degree_steps_follow_the_borders():
    # n = 2: degree 1 appends x0 and x1; degree 2 accepts x0^2, appends x0x1,
    # accepts x1^2; degree 3's border needs x0^2 in O: empty
    model = {"O": [(0, 0), (1, 0), (0, 1), (1, 1)],
             "G": [((2, 0), np.zeros(3), 0.0), ((0, 2), np.zeros(4), 0.0)]}
    steps = work.degree_steps(model, 100, 10)
    assert [(s["d"], s["ell0"], s["K"]) for s in steps] == [(1, 1, 2), (2, 3, 3)]
    assert steps[1]["gram"] == work.gram(100, 3, 3, 2)
    assert steps[1]["loop"] == work.candidate_loop([True, False, True], 3)
    assert work.degree_steps(model, 100, 1) == steps[:1]


def test_transform_and_fista_products():
    model = {"O": [(0,), (1,)], "G": [((2,), np.zeros(2), 0.0)]}
    assert work.transform(10, model) == 10 * (1 + 2 * 2 + 2)
    assert work.fista(100, 3, 2, 5) == 21 * 4 * 100 * 4 + 5 * 4 * 100 * 3 * 2


def test_roofline_share_takes_the_binding_bound():
    assert work.roofline_share(work.PEAK_FP32_FLOPS, 0.0, 2.0) == pytest.approx(50.0)
    assert work.roofline_share(0.0, work.PEAK_BYTES, 4.0) == pytest.approx(25.0)


def test_trace_reduce_merges_activity_and_names_idle_time():
    events = [("k1", 0.0, 1.0), ("k2", 0.5, 2.0), ("k1", 3.0, 4.0), ("copy", 9.5, 11.0)]
    phases = [("fit", 0.0, 2.5), ("svm", 2.5, 6.0)]
    red = trace.reduce(events, 0.0, 10.0, phases)
    assert red["busy_s"] == pytest.approx(2.0 + 1.0 + 0.5)
    assert red["window_s"] == 10.0
    assert red["kernels"]["k1"] == [2, 2.0]
    assert red["kernels"]["copy"] == [1, 0.5]
    assert red["idle"] == pytest.approx({"fit": 0.5, "svm": 2.5, "between": 3.5})
    b = trace.breakdown(red, top=2)
    assert [r[0] for r in b["device_ops"]] == ["k1", "k2"]
    assert b["idle_gaps"][0] == ["between", pytest.approx(3.5)]


def test_trace_reduce_of_an_empty_window_is_all_idle():
    red = trace.reduce([], 1.0, 3.0, [("fit", 1.0, 3.0)])
    assert red["busy_s"] == 0.0 and red["idle"] == pytest.approx({"fit": 2.0})


def test_decide_compares_each_number_with_its_limit():
    ok, checks = judge.decide({"structure": [], "a": 0.5, "b": 2.0}, {"structure": 0, "a": 1.0})
    assert ok and checks == {"structure": {"value": 0.0, "limit": 0.0},
                             "a": {"value": 0.5, "limit": 1.0}}
    assert not judge.decide({"structure": ["x"], "a": 0.5}, {"structure": 0, "a": 1.0})[0]
    assert not judge.decide({"structure": [], "a": 1.5}, {"structure": 0, "a": 1.0})[0]
    ok, checks = judge.decide({"structure": []}, {"structure": 0, "a": 1.0})
    assert not ok and math.isinf(checks["a"]["value"])
    assert not judge.decide({"structure": [], "a": float("nan")}, {"a": 1.0})[0]
    assert judge.lines(checks, ["bad"])[0] == "structure: bad"


def test_host_witness_pairs_the_probes():
    got = host.witness({"probe_ms": 10.12345, "launch_us": None},
                       {"probe_ms": 11.0, "launch_us": None})
    assert got == {"probe_ms": [10.123, 11.0]}
    assert host.launch_us("cpu") is None and host.probe_ms() > 0
