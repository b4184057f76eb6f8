"""The port's continuous controller (``repro_torch.launch.continuous_vi``) on
the CPU.

``continuous_vi.main`` with the arguments of the reference's loop test
(``tests/test_online.py``) and ``--device cpu``: zero bitwise mismatches,
every arrival activated, updates overlapping served requests, no kernel
build after the base fit.  Its final model is held two ways: against the
reference ``continuous_vi.main``'s final model on the same arguments
(terms equal, coefficients at the parity tolerance of
``tests/test_torch_streaming.py``), and bit for bit against the port's own
streamed refit of every row under the frozen base scaler.  The port's
journal replays the reference run's journal.  Then the drift gate, the
in-process resume decision, journal compaction and the obs export.
"""

import json
import os

import numpy as np
import pytest

from repro.launch import continuous_vi as j_continuous
from repro_torch import api, streaming
from repro_torch.core.oavi import OAVIConfig
from repro_torch.launch import continuous_vi
from repro_torch.resilience import Journal
from repro_torch.streaming import ScaledSource, ShardDirSource
from repro_torch.streaming.scaler import StreamingMinMaxScaler

LOOP_ARGS = [
    "--base-rows", "2048", "--increments", "3", "--increment-rows", "512",
    "--shard-rows", "512", "--chunk-rows", "512", "--min-update-rows", "1024",
    "--serve-threads", "2",
]
INV_TOL = dict(rtol=5e-3, atol=2e-3)  # tests/test_torch_streaming.py


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's loop and the reference's loop on the same arguments."""
    port_dir = str(tmp_path_factory.mktemp("port"))
    ref_dir = str(tmp_path_factory.mktemp("reference"))
    port = continuous_vi.main(LOOP_ARGS + ["--workdir", port_dir, "--device", "cpu"])
    ref = j_continuous.main(LOOP_ARGS + ["--workdir", ref_dir])
    return port, ref


def _assert_bit_equal(a, b):
    assert a.book.terms == b.book.terms
    assert [g.term for g in a.generators] == [g.term for g in b.generators]
    for ga, gb in zip(a.generators, b.generators):
        assert np.array_equal(ga.coeffs, gb.coeffs), ga.term


def test_continuous_vi_serves_bit_correct_during_refit(runs):
    report, _ = runs
    assert report["serve"]["mismatches"] == 0
    assert report["serve"]["requests"] > 0
    assert report["warm_recompiles"] == 0
    assert len(report["updates"]) >= 1
    assert report["versions_activated"] == 1 + len(report["updates"])
    assert len(report["staleness_s"]) == 3  # every arrival reached serving
    assert all(s > 0 for s in report["staleness_s"])
    assert report["serve"]["during_update_requests"] > 0  # true overlap
    assert report["health"] == "ok" and not report["update_failures"]
    assert all(u["recompiles"] == 0 for u in report["updates"])


def test_continuous_vi_final_model_against_reference(runs):
    from repro import api as japi

    port_rep, ref_rep = runs
    assert port_rep["total_rows"] == ref_rep["total_rows"] == 2048 + 3 * 512
    port = api.load(port_rep["final_model"], device="cpu")
    ref = japi.load(ref_rep["final_model"])
    assert port.book.terms == ref.book.terms
    assert [g.term for g in port.generators] == [g.term for g in ref.generators]
    for gp, gr in zip(port.generators, ref.generators):
        np.testing.assert_allclose(gp.coeffs, np.asarray(gr.coeffs), **INV_TOL)
    # the same arrivals: both loops ingested bit-identical shards
    for i in range(len(os.listdir(os.path.join(port_rep["workdir"], "shards"))) - 1):
        name = f"shard_{i:05d}.npy"
        assert np.array_equal(np.load(os.path.join(port_rep["workdir"], "shards", name)),
                              np.load(os.path.join(ref_rep["workdir"], "shards", name)))


def test_continuous_vi_final_model_equals_streamed_refit(runs):
    report, _ = runs
    base = continuous_vi.arrival_batch(-1, 2048, 3, 0)
    scaler = StreamingMinMaxScaler().fit(base)
    src = ScaledSource(ShardDirSource(os.path.join(report["workdir"], "shards")), scaler)
    assert src.num_rows == report["total_rows"]
    refit = streaming.fit(src, OAVIConfig(psi=0.005, engine="fast"), chunk_rows=512,
                          device="cpu")
    _assert_bit_equal(api.load(report["final_model"], device="cpu"), refit)


def test_port_journal_replays_reference_run(runs):
    port_rep, ref_rep = runs
    kinds = {}
    for name, rep in (("port", port_rep), ("reference", ref_rep)):
        with Journal(os.path.join(rep["workdir"], "journal.jsonl")) as j:
            kinds[name] = [r["kind"] for r in j.replay()]
    for ks in kinds.values():
        assert ks[0] == "base_fitted" and ks[-1] == "done"
        assert ks.count("ingested") == 3
        assert ks.count("activated") == ks.count("staged") == ks.count("state_saved")
    assert set(kinds["port"]) == set(kinds["reference"])


def test_continuous_vi_drift_gate_triggers(tmp_path):
    report = continuous_vi.main([
        "--base-rows", "2048", "--increments", "2", "--increment-rows", "512",
        "--shard-rows", "512", "--chunk-rows", "512", "--min-update-rows",
        "99999", "--drift-at-increment", "0", "--serve-threads", "1",
        "--workdir", str(tmp_path), "--device", "cpu",
    ])
    assert any(u["drift"]["triggered"] for u in report["updates"])
    assert report["serve"]["mismatches"] == 0


def test_continuous_vi_resume_compaction_and_obs(tmp_path):
    """A second run on a finished workdir resumes from the journal and the
    newest state (one catch-up update, nothing pending); ``--no-resume``
    restarts; ``--journal-max-records`` compacts after an activation and
    ``--obs-dir`` exports the flight recorder's files."""
    args = ["--base-rows", "1024", "--increments", "4", "--increment-rows", "256",
            "--shard-rows", "256", "--chunk-rows", "256", "--min-update-rows", "256",
            "--serve-threads", "1", "--workdir", str(tmp_path / "w"), "--device", "cpu"]
    obs_dir = str(tmp_path / "obs")
    first = continuous_vi.main(args + ["--journal-max-records", "6", "--obs-dir", obs_dir,
                                       "--out", str(tmp_path / "r.json")])
    assert first["serve"]["mismatches"] == 0 and not first["resume"]["resumed"]
    with open(tmp_path / "r.json") as f:
        assert json.load(f)["total_rows"] == 2048
    for name in ("trace.json", "metrics.jsonl", "slo.json"):
        assert os.path.getsize(os.path.join(obs_dir, name)) > 0
    with Journal(str(tmp_path / "w" / "journal.jsonl")) as j:
        records = j.replay()
    assert records[0]["kind"] == "base_fitted" and records[-1]["kind"] == "done"
    # compacted: records before an activation went, the survivors keep their seq
    seqs = [r["seq"] for r in records]
    assert seqs != list(range(len(records))) and seqs == sorted(seqs)
    again = continuous_vi.main(args)
    assert again["resume"]["resumed"]
    assert again["resume"]["caught_up_rows"] == 2048
    assert again["updates"] == []
    _assert_bit_equal(api.load(again["final_model"], device="cpu"),
                      api.load(first["final_model"], device="cpu"))
    fresh = continuous_vi.main(args + ["--no-resume"])
    assert not fresh["resume"]["resumed"]
    _assert_bit_equal(api.load(fresh["final_model"], device="cpu"),
                      api.load(first["final_model"], device="cpu"))
