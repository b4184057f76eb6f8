"""The port's sharding hints and meshes, on the CPU.

Without a mesh the hints are no-ops, as the reference's
(``tests/test_layers.py::test_hints_noop_without_mesh``).  Under a mesh the
port cleans each spec by the reference's rules and returns its input
unchanged (eager PyTorch has no partitioner): the cleaned specs are held to
those rules at a 1 x 1 local mesh, a real ``DeviceMesh`` over a gloo world
of one started in a subprocess (the main pytest process keeps no process
group), and at the production shapes through an abstract mesh.  The
reference's own test under a mesh fails under this jax (0.9.0), so each
cleaned spec is held against what the reference's ``constrain`` hands to
``with_sharding_constraint``, its mesh lookup stubbed.  Training under the local mesh gives the same
losses, bit for bit, as without one.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.models import hints as jhints
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import hints


def test_hints_noop_without_mesh():
    x = torch.ones((4, 4))
    y = hints.constrain(x, "data", None)
    assert y is x and hints.constrain_batch(x) is x
    assert hints.batch_axes() == () == jhints.batch_axes()
    assert hints.axis_sizes() == {} == jhints.axis_sizes()
    assert hints.current_mesh() is None


# (spec, {mesh sizes})
RULES = {
    "known-axes": (("data", ("model?", 8)), {"data": 1, "model": 1}),
    "unknown-axis": (("nonexistent", None), {"data": 1, "model": 1}),
    "model?-divides": ((None, ("model?", 32)), {"data": 16, "model": 16}),
    "model?-not": ((None, ("model?", 8)), {"data": 16, "model": 16}),
    "model?-no-model-axis": ((("model?", 8),), {"data": 4}),
    "tuple-kept": ((("pod", "data"), None), {"pod": 2, "data": 16, "model": 16}),
    "tuple-trimmed": ((("pod", "data"), "model"), {"data": 16, "model": 16}),
    "tuple-emptied": ((("pod",),), {"data": 16}),
}


def reference_clean(spec, sizes, monkeypatch):
    """The spec the reference's ``constrain`` hands to
    ``with_sharding_constraint`` under a mesh of ``sizes`` (its mesh lookup
    and the constraint itself stubbed, so no devices are needed)."""
    with monkeypatch.context() as mp:
        mp.setattr(jhints, "axis_sizes", lambda: dict(sizes))
        mp.setattr(jhints.jax.lax, "with_sharding_constraint", lambda x, s: s)
        return tuple(jhints.constrain(np.ones((4,) * len(spec)), *spec))


@pytest.mark.parametrize("case", sorted(RULES))
def test_clean_spec_follows_reference_rules(case, monkeypatch):
    spec, sizes = RULES[case]
    want = reference_clean(spec, sizes, monkeypatch)
    assert hints.clean_spec(spec, sizes) == want
    shape, names = tuple(sizes.values()), tuple(sizes)
    with hints.use_mesh(mesh_mod.AbstractMesh(shape, names)):
        assert hints.axis_sizes() == sizes
        assert hints.clean_spec(spec) == want
        x = torch.ones((4,) * len(spec))
        assert hints.constrain(x, *spec) is x
    assert hints.current_mesh() is None


def test_production_mesh_shapes_and_batch_axes():
    single = mesh_mod.abstract_production_mesh()
    multi = mesh_mod.abstract_production_mesh(multi_pod=True)
    assert single.shape == {"data": 16, "model": 16} and single.size() == 256
    assert multi.shape == {"pod": 2, "data": 16, "model": 16} and multi.size() == 512
    with hints.use_mesh(multi):
        assert hints.batch_axes() == ("pod", "data")
        with hints.use_mesh(single):  # nested: the inner mesh, then the outer again
            assert hints.batch_axes() == ("data",)
        assert hints.batch_axes() == ("pod", "data")
        with pytest.raises(ValueError, match="longer than the rank"):
            hints.constrain(torch.ones(3), "data", None)
    with pytest.raises(RuntimeError, match=r"needs 256 devices, have 1"):
        mesh_mod.make_production_mesh(device="cpu")


LOCAL_MESH = textwrap.dedent("""
    import dataclasses, json
    import torch
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.train import train
    from repro_torch.models import hints

    mesh = mesh_mod.make_local_mesh(device="cpu")
    out = dict(world=dist.get_world_size(), backend=dist.get_backend(),
               names=list(mesh.mesh_dim_names), shape=list(mesh.shape))
    with hints.use_mesh(mesh):
        x = torch.ones((4, 8))
        out["sizes"] = hints.axis_sizes()
        out["batch_axes"] = list(hints.batch_axes())
        out["same"] = hints.constrain(x, "data", ("model?", 8)) is x
        out["clean"] = [hints.clean_spec(("data", ("model?", 8))),
                        hints.clean_spec(("nonexistent", None))]
    try:
        mesh_mod.make_production_mesh(device="cpu")
    except RuntimeError as e:
        out["production"] = str(e)
    cfg = configs.get_reduced("deepseek-v2-lite-16b")
    cfg = dataclasses.replace(cfg, moe=cfg.moe._replace(dispatch="rowwise"))
    kw = dict(steps=2, global_batch=2, seq_len=16, log_every=100, device="cpu")
    out["losses_mesh"] = train(cfg, mesh=mesh, **kw)["losses"]
    out["losses_none"] = train(cfg, mesh=None, **kw)["losses"]
    dist.destroy_process_group()
    print(json.dumps(out))
""")


def test_local_cpu_mesh_in_a_world_of_one(monkeypatch):
    """``make_local_mesh(device="cpu")`` starts a gloo world of one and
    builds a 1 x 1 (data, model) ``DeviceMesh``; the hints see it, clean by
    the reference's rules, return their input; training under it (rowwise
    MoE: one row) gives the same losses bit for bit as without."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath("src"))
    res = subprocess.run([sys.executable, "-c", LOCAL_MESH], capture_output=True, text=True,
                         env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    import json

    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["world"] == 1 and out["backend"] == "gloo"
    assert out["names"] == ["data", "model"] and out["shape"] == [1, 1]
    assert out["sizes"] == {"data": 1, "model": 1} and out["batch_axes"] == ["data"]
    assert out["same"] is True
    one = {"data": 1, "model": 1}
    assert out["clean"] == [list(reference_clean(spec, one, monkeypatch))
                            for spec in (("data", ("model?", 8)), ("nonexistent", None))]
    assert "needs 256 devices, have 1" in out["production"]
    assert len(out["losses_mesh"]) == 2 and np.all(np.isfinite(out["losses_mesh"]))
    assert out["losses_mesh"] == out["losses_none"]
