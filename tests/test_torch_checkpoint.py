"""The port's checkpoint store, integrity checks and model/classifier
save-load, on the CPU.

* ``repro_torch.checkpoint.store`` writes the JAX package's format byte for
  byte: the same tree saved by both stores gives identical files (manifest
  included), and each store restores the other's checkpoints.
* Integrity: a flipped bit or a truncated leaf raises ``IntegrityError``
  naming the file; a corrupt head falls back to the newest verifiable step;
  ``.tmp`` wreckage is ignored; v1 manifests (no checksums) still load.
* Models and classifiers: saved by ``repro``, loaded by ``repro_torch`` (and
  the other way), they transform and predict as the originals.  Across
  packages the features are held at rtol 1e-5, atol 1e-6 (the same
  coefficients; only the final product's summation order differs, as in
  ``tests/test_torch_oavi.py::test_carry_across_reference_model``); the
  port's own save -> load round trip is bit-identical.
"""

import json
import os

import numpy as np
import pytest
import torch

from repro import api as japi
from repro.checkpoint import store as jstore
from repro.core.pipeline import PipelineConfig as JConfig
from repro.core.pipeline import VanishingIdealClassifier as JClassifier
from repro.resilience import integrity as jintegrity
from repro_torch import api
from repro_torch.checkpoint import store
from repro_torch.core.pipeline import (
    CLASSIFIER_FORMAT,
    PipelineConfig,
    VanishingIdealClassifier,
)
from repro_torch.resilience import integrity
from repro_torch.resilience.integrity import IntegrityError

PSI = 0.005
CROSS_TOL = dict(rtol=1e-5, atol=1e-6)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.normal(size=(7, 5)).astype(np.float32),
        "b": rng.normal(size=(5,)).astype(np.float64),
        "idx": np.arange(9, dtype=np.int32),
        "flags": rng.uniform(size=4) > 0.5,
        "nested": {"z": np.zeros((0,), np.int32), "s": np.float32(2.5)},
        "list": [np.ones((2, 2), np.float32), np.int64(3)],
    }


def _files(path):
    return {name: open(os.path.join(path, name), "rb").read()
            for name in sorted(os.listdir(path))}


def test_store_writes_reference_bytes(tmp_path):
    tree = _tree()
    meta = {"format": "x", "n": 3}
    a = store.save(str(tmp_path / "port"), 7, tree, meta)
    b = jstore.save(str(tmp_path / "ref"), 7, tree, meta)
    assert os.path.basename(a) == os.path.basename(b) == "step_00000007"
    assert _files(a) == _files(b)


def test_tensor_leaves_write_reference_bytes(tmp_path):
    """Tensors are written as the numpy arrays ``jax.device_get`` gives: C
    order whatever the tensor's strides, bf16 upcast with its name kept."""
    w = torch.arange(12, dtype=torch.float32).reshape(3, 4).T  # not contiguous
    h = torch.tensor([1.5, -2.25, 3.0], dtype=torch.bfloat16)
    store.save(str(tmp_path / "port"), 0, {"w": w, "h": h})
    jstore.save(str(tmp_path / "ref"), 0,
                {"w": np.ascontiguousarray(w.numpy()), "h": h.float().numpy()})
    port = _files(str(tmp_path / "port" / "step_00000000"))
    ref = _files(str(tmp_path / "ref" / "step_00000000"))
    assert port["leaf_00001.npy"] == ref["leaf_00001.npy"]  # "w"
    assert port["leaf_00000.npy"] == ref["leaf_00000.npy"]  # "h" as float32
    manifest = json.loads(port["manifest.json"])
    assert manifest["leaves"][0]["extension_dtype"] == "bfloat16"
    tree, _ = store.restore(str(tmp_path / "port"), 0, {"w": 0, "h": 0})
    assert torch.equal(tree["h"], h)
    assert np.array_equal(tree["w"], w.numpy())


def test_store_round_trip_and_cross_restore(tmp_path):
    tree = _tree(1)
    for save, restore in ((store.save, jstore.restore), (jstore.save, store.restore),
                          (store.save, store.restore)):
        path = str(tmp_path / f"{save.__module__}-{restore.__module__}")
        save(path, 3, tree, {"k": 1})
        got, meta = restore(path, 3, tree)
        assert meta == {"k": 1}
        flat_got = [np.asarray(x) for x in store._flatten(got)[1]]
        flat_want = store._flatten(tree)[1]
        assert len(flat_got) == len(flat_want)
        for g, w in zip(flat_got, flat_want):
            assert g.dtype == np.asarray(w).dtype and np.array_equal(g, w)


def test_flipped_bit_names_the_leaf(tmp_path):
    path = str(tmp_path / "ck")
    store.save(path, 0, _tree())
    leaf = os.path.join(path, "step_00000000", "leaf_00003.npy")
    integrity.flip_bit(leaf, -1, bit=3)
    with pytest.raises(IntegrityError, match="leaf_00003.npy") as err:
        store.restore(path, 0, _tree())
    assert err.value.path == leaf
    with pytest.raises(IntegrityError, match="checksum mismatch"):
        store.verify(path, 0)
    # the reference's verifier sees the same corruption
    with pytest.raises(jintegrity.IntegrityError, match="leaf_00003.npy"):
        jstore.verify(path, 0)


def test_truncated_leaf_reports_truncation(tmp_path):
    path = str(tmp_path / "ck")
    store.save(path, 0, _tree())
    leaf = os.path.join(path, "step_00000000", "leaf_00000.npy")
    integrity.truncate_file(leaf, 10)
    with pytest.raises(IntegrityError, match="truncated"):
        store.verify(path, 0)


def test_fallback_to_older_committed_step(tmp_path):
    path = str(tmp_path / "ck")
    store.save(path, 1, _tree(1))
    store.save(path, 2, _tree(2))
    integrity.flip_bit(os.path.join(path, "step_00000002", "leaf_00000.npy"), 100)
    assert store.committed_steps(path) == [1, 2]
    assert store.latest_verifiable_step(path) == 1
    tree, _, step = store.load_latest(path, _tree())
    assert step == 1
    assert np.array_equal(tree["w"], _tree(1)["w"])
    integrity.flip_bit(os.path.join(path, "step_00000001", "leaf_00000.npy"), 100)
    with pytest.raises(IntegrityError, match="every committed checkpoint"):
        store.load_latest(path, _tree())


def test_tmp_directory_ignored(tmp_path):
    path = str(tmp_path / "ck")
    store.save(path, 1, _tree())
    os.makedirs(os.path.join(path, "step_00000005.tmp"))
    open(os.path.join(path, "step_00000005.tmp", "COMMITTED"), "w").write("ok")
    os.makedirs(os.path.join(path, "step_00000006"))  # no marker: junk
    assert store.committed_steps(path) == [1]
    assert store.latest_step(path) == 1
    store.save(path, 5, _tree())  # the next save overwrites the wreckage
    assert store.committed_steps(path) == [1, 5]
    store.cleanup(path, keep_last=1)
    assert store.committed_steps(path) == [5]


def test_v1_manifest_reads(tmp_path):
    path = str(tmp_path / "ck")
    store.save(path, 0, _tree(), {"m": 2})
    mpath = os.path.join(path, "step_00000000", "manifest.json")
    manifest = json.load(open(mpath))
    manifest["manifest_version"] = 1
    for entry in manifest["leaves"]:
        del entry["checksum"], entry["bytes"]
    json.dump(manifest, open(mpath, "w"))
    store.verify(path, 0)
    tree, meta = store.restore(path, 0, _tree())
    assert meta == {"m": 2} and np.array_equal(tree["idx"], _tree()["idx"])
    assert store.read_metadata(path) == ({"m": 2}, 0)
    os.remove(os.path.join(path, "step_00000000", "leaf_00001.npy"))
    with pytest.raises(IntegrityError, match="missing"):
        store.verify(path, 0)


def test_async_saver(tmp_path):
    saver = store.AsyncSaver()
    t = torch.arange(6.0)
    saver.save(str(tmp_path / "ck"), 4, {"t": t})
    t.add_(100.0)  # the snapshot was taken on the call
    saver.wait()
    tree, _ = store.restore(str(tmp_path / "ck"), 4, {"t": 0})
    assert np.array_equal(tree["t"], np.arange(6.0, dtype=np.float32))
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    saver.save(str(blocker), 0, {"t": t})
    with pytest.raises(RuntimeError, match="does NOT exist"):
        saver.wait()


def test_integrity_copy_matches_reference(tmp_path):
    data = os.urandom(3000)
    assert integrity.checksum_bytes(data) == jintegrity.checksum_bytes(data)
    f = tmp_path / "blob"
    f.write_bytes(data)
    assert integrity.checksum_file(str(f)) == jintegrity.checksum_file(str(f))
    integrity.verify_file(str(f), integrity.checksum_bytes(data), len(data))


# ---------------------------------------------------------------------------
# Models and classifiers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def data(appc_small, planted_cube):
    return np.asarray(planted_cube), appc_small


def test_model_round_trip_bit_identical(tmp_path, data):
    X = data[0]
    model = api.fit(X, "oavi:cgavi-ihb", psi=PSI, device="cpu")
    path = model.save(str(tmp_path / "m"))
    assert path.endswith("step_00000000")
    again = api.load(str(tmp_path / "m"), device="cpu")
    assert again.book.terms == model.book.terms
    assert np.array_equal(again.transform(X), model.transform(X))
    assert again.stats["solver_iters"] == model.stats["solver_iters"]


def test_reference_model_loads_in_port(tmp_path, data):
    X = data[0]
    ref = japi.fit(X, "oavi:cgavi-ihb", psi=PSI, backend="local")
    ref.save(str(tmp_path / "m"))
    port = api.load(str(tmp_path / "m"), device="cpu")
    assert port.book.terms == ref.book.terms
    assert [g.term for g in port.generators] == [g.term for g in ref.generators]
    for gp, gr in zip(port.generators, ref.generators):
        assert np.array_equal(gp.coeffs, gr.coeffs)
    np.testing.assert_allclose(port.transform(X), ref.transform(X), **CROSS_TOL)


def test_port_model_loads_in_reference(tmp_path, data):
    X = data[0]
    port = api.fit(X, "oavi", psi=PSI, device="cpu")
    api.save(port, str(tmp_path / "m"))
    ref = japi.load(str(tmp_path / "m"))
    assert ref.book.terms == port.book.terms
    for gp, gr in zip(port.generators, ref.generators):
        assert np.array_equal(gp.coeffs, gr.coeffs)
    np.testing.assert_allclose(np.asarray(ref.transform(X)), port.transform(X), **CROSS_TOL)


def test_load_falls_back_past_corrupt_head(tmp_path, data):
    X = data[0]
    a = api.fit(X, "oavi", psi=PSI, device="cpu")
    b = api.fit(X, "oavi", psi=0.02, device="cpu")
    path = str(tmp_path / "m")
    for step, model in ((0, a), (1, b)):
        arrays, meta = model.to_state_dict()
        api.save_state_dict(path, arrays, meta, api._FORMAT, step=step)
    assert api.load(path, device="cpu").psi == 0.02
    integrity.flip_bit(os.path.join(path, "step_00000001", "leaf_00003.npy"), -2)
    back = api.load(path, device="cpu")
    assert back.psi == PSI and np.array_equal(back.transform(X), a.transform(X))
    integrity.flip_bit(os.path.join(path, "step_00000000", "leaf_00000.npy"), -2)
    with pytest.raises(IntegrityError, match="step_00000001"):
        api.load(path, device="cpu")


def test_load_checks_format_and_kind(tmp_path, data):
    X = data[0]
    model = api.fit(X, "oavi", psi=PSI, device="cpu")
    path = str(tmp_path / "m")
    arrays, meta = model.to_state_dict()
    api.save_state_dict(path, arrays, meta, CLASSIFIER_FORMAT)
    with pytest.raises(ValueError, match="not a repro.vanishing_ideal_model.v1"):
        api.load(path, device="cpu")
    with pytest.raises(FileNotFoundError):
        api.load(str(tmp_path / "nothing"), device="cpu")
    vca_model = api.fit(X, "vca", psi=PSI, device="cpu")
    vca = str(tmp_path / "vca")
    vca_model.save(vca)
    back = api.load(vca, device="cpu")
    assert type(back) is type(vca_model) and back.num_G == vca_model.num_G
    assert np.array_equal(back.transform(X), vca_model.transform(X))
    bad = str(tmp_path / "bad")
    api.save_state_dict(bad, arrays, dict(meta, kind="nope"), api._FORMAT)
    with pytest.raises(ValueError, match="unknown model kind"):
        api.load(bad, device="cpu")


@pytest.fixture(scope="module")
def classifiers(data):
    Xtr, ytr = data[1][0], data[1][1]
    ref = JClassifier(JConfig(method="cgavi-ihb", psi=PSI, class_batch="off")).fit(Xtr, ytr)
    port = VanishingIdealClassifier(PipelineConfig(method="cgavi-ihb", psi=PSI),
                                    device="cpu").fit(Xtr, ytr)
    return ref, port


def test_classifier_round_trip_bit_identical(tmp_path, data, classifiers):
    Xte = data[1][2]
    _, port = classifiers
    port.save(str(tmp_path / "c"))
    again = VanishingIdealClassifier.load(str(tmp_path / "c"), device="cpu")
    assert np.array_equal(again.transform(Xte), port.transform(Xte))
    assert np.array_equal(again.predict(Xte), port.predict(Xte))
    assert again.config == port.config
    assert again.svm.stats == port.svm.stats


def test_reference_classifier_loads_in_port(tmp_path, data, classifiers):
    Xte = data[1][2]
    ref, _ = classifiers
    ref.save(str(tmp_path / "c"))
    port = VanishingIdealClassifier.load(str(tmp_path / "c"), device="cpu")
    feats = ref.transform(Xte)
    np.testing.assert_allclose(port.transform(Xte), feats, **CROSS_TOL)
    assert np.array_equal(port.svm.W, ref.svm.W) and np.array_equal(port.classes_, ref.classes_)
    scores = ref.svm.decision_function(feats)
    top2 = np.sort(scores, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 1e-4
    assert np.array_equal(port.predict(Xte)[clear], ref.predict(Xte)[clear])


def test_port_classifier_loads_in_reference(tmp_path, data, classifiers):
    Xte = data[1][2]
    _, port = classifiers
    port.save(str(tmp_path / "c"))
    ref = JClassifier.load(str(tmp_path / "c"))
    feats = port.transform(Xte)
    np.testing.assert_allclose(np.asarray(ref.transform(Xte)), feats, **CROSS_TOL)
    scores = port.svm.decision_function(feats)
    top2 = np.sort(scores, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 1e-4
    assert np.array_equal(ref.predict(Xte)[clear], port.predict(Xte)[clear])
    assert ref.config.method == "cgavi-ihb"
