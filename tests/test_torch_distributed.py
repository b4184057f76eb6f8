"""Data-parallel OAVI on the port (``repro_torch.core.distributed``) on the CPU.

A world of one (a one-rank gloo group in the test process, destroyed in a
``finally``; or no process group at all) is the local fit bit for bit: the
in-memory, class-batched and streamed fits.  Worlds of 2 and 4 ranks, and a
2 x 2 mesh sharded over both of its dims, run as spawned processes that
meet through a ``FileStore`` in ``tmp_path`` (no TCP port, so parallel test
workers never collide), each under a timeout.  Every rank's model must be
the same bit for bit, and the models are held against the JAX package's
LOCAL fits (its sharded fits need a jax that this sandbox's lacks) at the
reference's own tolerance (``tests/test_distributed.py``: terms exact,
coefficients rtol 5e-3 / atol 2e-3).  The streamed sharded fit equals the
in-memory sharded fit bit for bit at world 2.  Last, the API's backend
dispatch.
"""

import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro.core import class_batch as j_class_batch
from repro.core import oavi as j_oavi
from repro.core.oavi import OAVIConfig as JConfig
from repro.data.synthetic import _planted_class
from repro_torch import api, streaming
from repro_torch.core import class_batch, distributed, oavi
from repro_torch.core.oavi import OAVIConfig

TOL = dict(rtol=5e-3, atol=2e-3)
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
RANK_TIMEOUT_S = 180


def _data_1003():
    rng = np.random.default_rng(0)
    X = rng.uniform(0, 1, (1003, 4))  # a multiple of neither 2, 4 nor the Gram block
    X[:, 3] = np.clip(X[:, 0] * X[:, 1] + rng.normal(0, 0.01, 1003), 0, 1)
    return X.astype(np.float32)


def _data_640():
    return np.random.default_rng(1).uniform(0, 1, (640, 3)).astype(np.float32)


def _classes():
    return [np.clip(_planted_class(np.random.default_rng(c), 1003, 4), 0, 1)
            .astype(np.float32) for c in range(3)]


CFG_1003 = dict(psi=0.005, engine="fast", cap_terms=64, ordering="none")
CFG_640 = dict(psi=0.01, engine="fast", cap_terms=64, ordering="none")
CFG_CLASSES = dict(psi=0.005, engine="fast", cap_terms=64)


def _summary(model):
    return {"terms": list(model.book.terms),
            "gens": [(g.term, np.asarray(g.coeffs)) for g in model.generators],
            "stats": {k: model.stats.get(k) for k in (
                "degrees", "all_reduces", "m_padded", "mesh", "data_axes", "api")}}


# The rank program: every rank fits the same data and pickles what it got.
RANK = """
import os, pickle, sys
import numpy as np
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

rank, world, work, case = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", store=dist.FileStore(os.path.join(work, "store"), world),
                        rank=rank, world_size=world)
try:
    from repro_torch import api, streaming
    from repro_torch.core import class_batch, distributed
    from repro_torch.core.oavi import OAVIConfig

    def summary(model):
        return {"terms": list(model.book.terms),
                "gens": [(g.term, np.asarray(g.coeffs)) for g in model.generators],
                "stats": {k: model.stats.get(k) for k in (
                    "degrees", "all_reduces", "m_padded", "mesh", "data_axes", "api")}}

    data = np.load(os.path.join(work, "data.npz"))
    out = {}
    if case == "mesh2x2":
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        out["fit"] = summary(distributed.fit(
            data["X"], OAVIConfig(psi=0.01, engine="fast", cap_terms=64, ordering="none"),
            mesh=mesh, data_axes=("data", "model"), device="cpu"))
    else:
        mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
        cfg = OAVIConfig(psi=0.005, engine="fast", cap_terms=64, ordering="none")
        out["fit"] = summary(distributed.fit(data["X"], cfg, mesh=mesh, device="cpu"))
        out["streamed"] = summary(streaming.fit(data["X"], cfg, chunk_rows=256, mesh=mesh,
                                                device="cpu"))
        Xs = [data[f"X{c}"] for c in range(3)]
        ccfg = OAVIConfig(psi=0.005, engine="fast", cap_terms=64)
        out["classes"] = [summary(m) for m in class_batch.fit_classes(
            Xs, ccfg, mesh=mesh, device="cpu")]
        out["classes_streamed"] = [summary(m) for m in streaming.fit_classes(
            Xs, ccfg, chunk_rows=256, mesh=mesh, device="cpu")]
        # the API: auto shards on a world of several ranks once m is large
        big = np.random.default_rng(5).uniform(0, 1, (api.AUTO_SHARD_MIN_M, 3))
        out["auto_big"] = summary(api.fit(big.astype(np.float32), device="cpu"))
        out["auto_small"] = summary(api.fit(data["X"], device="cpu"))
        out["api_classes"] = [summary(m) for m in api.fit_classes(
            Xs, "oavi:fast", psi=0.005, backend="sharded", device="cpu")]
    with open(os.path.join(work, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
finally:
    dist.destroy_process_group()
"""


def _spawn(tmp_path, world, case, **arrays):
    """Run the rank program on ``world`` ranks; returns each rank's results."""
    work = str(tmp_path)
    np.savez(os.path.join(work, "data.npz"), **arrays)
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", textwrap.dedent(RANK), str(r),
                               str(world), work, case], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(world)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=RANK_TIMEOUT_S)
            if p.returncode:
                errs.append(err[-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert not errs, errs[0]
    out = []
    for r in range(world):
        with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _assert_same_bits(a, b):
    assert a["terms"] == b["terms"]
    assert [t for t, _ in a["gens"]] == [t for t, _ in b["gens"]]
    for (_, ca), (_, cb) in zip(a["gens"], b["gens"]):
        assert ca.tobytes() == cb.tobytes()


def _assert_ranks_identical(results, key):
    """Every rank's summaries under ``key`` (one model or a list) equal rank 0's."""
    as_list = lambda x: x if isinstance(x, list) else [x]  # noqa: E731
    for other in results[1:]:
        for a, b in zip(as_list(results[0][key]), as_list(other[key])):
            _assert_same_bits(a, b)


def _assert_close_to_reference(summary, ref):
    assert summary["terms"] == list(ref.book.terms)
    assert [t for t, _ in summary["gens"]] == [g.term for g in ref.generators]
    for (_, c), g in zip(summary["gens"], ref.generators):
        np.testing.assert_allclose(c, np.asarray(g.coeffs), **TOL)


def _assert_bit_equal(a, b):
    _assert_same_bits(_summary(a), _summary(b))


# ---------------------------------------------------------------------------
# world of one


@pytest.fixture
def world_of_one(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        yield init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
    finally:
        dist.destroy_process_group()


def test_world_of_one_fit_is_local_bit_for_bit(world_of_one):
    X = _data_1003()
    cfg = OAVIConfig(**CFG_1003)
    local = oavi.fit(X, cfg, device="cpu")
    sharded = distributed.fit(X, cfg, mesh=world_of_one, device="cpu")
    _assert_bit_equal(sharded, local)
    st = sharded.stats
    assert st["all_reduces"] == len(st["degrees"]) == len(local.stats["degrees"])
    assert st["mesh"] == {"data": 1} and st["m_padded"] == 1024
    assert st["kernel_launches"] == local.stats["kernel_launches"]
    via_api = api.fit(X, "oavi:fast", psi=0.005, cap_terms=64, ordering="none",
                      backend="sharded", mesh=world_of_one, device="cpu")
    assert via_api.stats["api"]["backend"] == "sharded"
    _assert_bit_equal(via_api, local)


def test_world_of_one_class_batched_and_streamed_are_local(world_of_one):
    Xs = _classes()
    cfg = OAVIConfig(**CFG_CLASSES)
    local = class_batch.fit_classes(Xs, cfg, device="cpu")
    sharded = class_batch.fit_classes(Xs, cfg, mesh=world_of_one, device="cpu")
    for a, b in zip(sharded, local):
        _assert_bit_equal(a, b)
        assert a.stats["all_reduces"] == max(len(m.stats["degrees"]) for m in local)
    streamed = streaming.fit_classes(Xs, cfg, chunk_rows=256, mesh=world_of_one,
                                     device="cpu")
    for a, b in zip(streamed, streaming.fit_classes(Xs, cfg, chunk_rows=256, device="cpu")):
        _assert_bit_equal(a, b)
    X = _data_1003()
    one = streaming.fit(X, OAVIConfig(**CFG_1003), chunk_rows=256, mesh=world_of_one,
                        device="cpu")
    _assert_bit_equal(one, oavi.fit(X, OAVIConfig(**CFG_1003), device="cpu"))
    assert one.stats["all_reduces"] == len(one.stats["degrees"])


def test_sharded_without_process_group_is_a_world_of_one():
    assert not dist.is_initialized()
    X = _data_1003()
    model = api.fit(X, "oavi:fast", psi=0.005, cap_terms=64, ordering="none",
                    backend="sharded", device="cpu")
    assert model.stats["api"]["backend"] == "sharded"
    assert model.stats["all_reduces"] == 0 and model.stats["mesh"] == {}
    _assert_bit_equal(model, oavi.fit(X, OAVIConfig(**CFG_1003), device="cpu"))
    streamed = api.fit(X, "oavi:fast", psi=0.005, cap_terms=64, ordering="none",
                       chunk_rows=512, backend="sharded", device="cpu")
    assert streamed.stats["api"]["backend"] == "sharded"
    _assert_bit_equal(streamed, model)


# ---------------------------------------------------------------------------
# several ranks (spawned)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_fits_match_reference_local(tmp_path, world):
    X = _data_1003()
    Xs = _classes()
    results = _spawn(tmp_path, world, "data", X=X, **{f"X{c}": Xs[c] for c in range(3)})
    for key in ("fit", "streamed", "classes", "classes_streamed", "auto_big", "api_classes"):
        _assert_ranks_identical(results, key)
    res = results[0]
    # the one-class fit against the reference's local fit
    ref = j_oavi.fit(X, JConfig(**CFG_1003))
    _assert_close_to_reference(res["fit"], ref)
    st = res["fit"]["stats"]
    assert st["all_reduces"] == len(st["degrees"]) == len(ref.stats["degrees"])
    assert st["mesh"] == {"data": world} and st["m_padded"] == 1024
    # the streamed sharded fit is the in-memory sharded fit, bit for bit
    _assert_same_bits(res["streamed"], res["fit"])
    assert res["streamed"]["stats"]["all_reduces"] == len(st["degrees"])
    # class-batched (in memory and streamed) against the reference's local batch
    refs = j_class_batch.fit_classes(Xs, JConfig(**CFG_CLASSES))
    for key in ("classes", "classes_streamed", "api_classes"):
        for got, want in zip(res[key], refs):
            _assert_close_to_reference(got, want)
    degrees = max(len(m.stats["degrees"]) for m in refs)
    assert all(m["stats"]["all_reduces"] == degrees for m in res["classes"])
    assert all(m["stats"]["api"]["backend"] == "sharded" for m in res["api_classes"])
    # auto: sharded at m >= AUTO_SHARD_MIN_M on several ranks, local below it
    big = res["auto_big"]["stats"]
    assert big["api"]["backend"] == "sharded" and big["mesh"] == {"data": world}
    assert big["all_reduces"] == len(big["degrees"])
    assert res["auto_small"]["stats"]["api"]["backend"] == "local"


def test_sharded_fit_on_2x2_mesh_over_both_dims(tmp_path):
    X = _data_640()
    results = _spawn(tmp_path, 4, "mesh2x2", X=X)
    _assert_ranks_identical(results, "fit")
    res = results[0]["fit"]
    _assert_close_to_reference(res, j_oavi.fit(X, JConfig(**CFG_640)))
    st = res["stats"]
    assert st["mesh"] == {"data": 2, "model": 2} and st["data_axes"] == ["data", "model"]
    assert st["all_reduces"] == len(st["degrees"]) and st["m_padded"] == 1024


def test_layout_spans_cover_the_padded_rows():
    rows = [distributed.ShardLayout(None, 4, i, {}, ("data",)).rows(1003) for i in range(4)]
    assert [r[0] for r in rows] == [0, 256, 512, 768]
    assert {r[1] for r in rows} == {256} and {r[2] for r in rows} == {1024}
    assert distributed.layout(None).rows(1003) == (0, 1024, 1024)
    with pytest.raises(ValueError, match="data_axes"):
        distributed.layout(type("M", (), {"mesh_dim_names": ("data",)})(), ("model",))


# ---------------------------------------------------------------------------
# API dispatch


def test_backend_dispatch_rules():
    X = _data_1003()
    local = api.fit(X, device="cpu")  # auto, no process group: local
    assert local.stats["api"]["backend"] == "local" and "all_reduces" not in local.stats
    for spec in ("abm", "vca"):
        with pytest.raises(ValueError, match="does not support backend='sharded'"):
            api.fit(X, spec, backend="sharded", device="cpu")
        with pytest.raises(ValueError, match="does not support backend='sharded'"):
            api.fit_classes([X, X], spec, backend="sharded", device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        api.fit(X, backend="tpu", device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        api.fit(X, chunk_rows=512, backend="tpu", device="cpu")
    with pytest.raises(ValueError, match="local-only"):
        api.fit(X, chunk_rows=512, capture_state=True, backend="sharded", device="cpu")
    sharded = api.fit(X, backend="sharded", device="cpu")
    state = api.fit(X, chunk_rows=512, capture_state=True, device="cpu").fit_state
    with pytest.raises(ValueError, match="local-only"):
        api.update(sharded, state, streaming.as_source(X), device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        api.fit(X, backend="sharded", data_axes=("data", "model"), device="cpu")


def test_classifier_sharded_backend_is_a_world_of_one():
    """``PipelineConfig(backend="sharded")`` without a process group fits the
    per-class generators as a world of one: the local classifier's bits."""
    from repro_torch.core.pipeline import PipelineConfig, VanishingIdealClassifier
    from repro_torch.data import synthetic

    X, y = synthetic.appendix_c(m=3000, seed=0)
    local = VanishingIdealClassifier(PipelineConfig(), device="cpu").fit(X, y)
    sharded = VanishingIdealClassifier(PipelineConfig(backend="sharded", mesh=None),
                                       device="cpu").fit(X, y)
    for a, b in zip(sharded.models, local.models):
        assert a.stats["api"]["backend"] == "sharded"
        _assert_bit_equal(a, b)
    assert np.array_equal(sharded.predict(X), local.predict(X))
