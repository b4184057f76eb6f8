"""The rank program of ``tests/test_torch_tensor_parallel.py``.

Run as ``python _torch_tensor_parallel_ranks.py RANK WORLD WORKDIR``: the
ranks meet through a gloo ``FileStore`` in WORKDIR, read ``cases.json`` and
each case's initial parameters (``<arch>.npz`` for training, the JAX
package's jitted init converted; ``<arch>_serve.npz`` for serving, its eager
init, as its ``serve`` draws them), run every case of their world on the
meshes the cases name (``(data, model)``, row-major, the model index
fastest: ``make_local_mesh(model_parallel=k)``'s layout), and write what
they got to ``world<WORLD>_rank<RANK>.pt``.  Nothing here imports JAX.
"""

import dataclasses
import datetime
import json
import os
import sys

import numpy as np
import torch

import _torch_train_mesh_ranks as R

# the faults the card's phase 19 plants: one definition, chip_smoke.py's
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import TPControl  # noqa: E402
from repro_torch import configs
from repro_torch.data import lm as lm_data
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import train as train_mod
from repro_torch.models import model as M
from repro_torch.runtime import tensor_parallel as tp

BATCH, SEQ, STEPS = R.BATCH, R.SEQ, R.STEPS


def case_config(case):
    """A case's reduced config: its arch, its MoE ``dispatch`` where it names
    one, and the chunked CE where it names a ``ce_chunk``."""
    cfg = R.config(case)
    if case.get("ce_chunk"):
        cfg = dataclasses.replace(cfg, ce_impl="chunked", ce_chunk=case["ce_chunk"])
    return cfg


def load(work, name):
    with np.load(os.path.join(work, f"{name}.npz")) as f:
        return {k: torch.from_numpy(f[k]) for k in f.files}


def case_params(work, case, suffix=""):
    """The case's initial parameters, or None for the port's seeded init."""
    return None if case.get("random") else load(work, case["arch"] + suffix)


def _numpy(tree):
    return {k: v.detach().cpu().numpy().copy() for k, v in tree.items()}


def first_grads(cfg, params, mesh):
    """Step 0's gradients on this rank's rows, synchronised by the plan
    (averaged over the batch ranks, summed where a model rank holds them in
    part) and gathered into the one-device layout, and the loss."""
    opt = R.optimizer()
    model, p, _, plan = train_mod.make_sharded_train_state(cfg, opt, mesh, device="cpu",
                                                           params=params)
    batch = {"tokens": lm_data.batch_for_mesh(R.pipe(cfg), 0, mesh, M.batch_axes(mesh),
                                              device="cpu")}
    with plan.scope():
        plan.gather_params(model, p)
        loss, grads = M.loss_and_grads(model, batch)
        grads = plan.sync_grads(grads)
        plan.release_params(model)
    return float(plan.mean_loss(loss.detach())), _numpy(plan.full_state({"g": grads})["g"])


def run_steps(cfg, params, mesh):
    """:func:`_torch_train_mesh_ranks.run_steps` plus the bytes this rank
    holds between steps (its parameter and moment tensors)."""
    opt = R.optimizer()
    model, p, st, plan = train_mod.make_sharded_train_state(cfg, opt, mesh, device="cpu",
                                                            params=params)
    held = sum(t.numel() * t.element_size() for t in [*p.values(), *st.mu.values(),
                                                        *st.nu.values()])
    out = R.run_steps(cfg, params, mesh, opt)
    out["held"] = held
    return out


def f_and_g(mesh):
    """``f`` and ``g`` on the model group of ``mesh``: each rank feeds
    ``x_r`` and backpropagates ``w_r``; returns the outputs and gradients."""
    plan = train_mod.DataParallelPlan(configs.get_reduced("qwen2-1.5b"),
                                      M.abstract_params(configs.get_reduced("qwen2-1.5b")),
                                      mesh)
    r = plan.model_index
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10.0 * r
    w = torch.full((2, 3), 1.0 + r)
    out = {}
    with plan.scope():
        for name, fn in (("f", tp.copy_to_model), ("g", tp.reduce_from_model)):
            xi = x.clone().requires_grad_(True)
            y = fn(xi)
            (gx,) = torch.autograd.grad(y, xi, grad_outputs=w)
            out[name] = dict(y=y.detach(), grad=gx)
    out["issued"] = dict(plan.comm.bytes)
    return out


def main(rank, world, work):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    with open(os.path.join(work, "cases.json")) as f:
        spec = json.load(f)[str(world)]
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(work, f"store{world}"),
                                                         world),
                            rank=rank, world_size=world, timeout=datetime.timedelta(seconds=120))
    meshes = {}

    def mesh_of(shape):
        shape = tuple(shape)
        if shape not in meshes:  # every rank builds them in the same order
            meshes[shape] = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
        return meshes[shape]

    try:
        out = {}
        for case in spec["cases"]:
            name, mesh = case["name"], mesh_of(case["mesh"])
            kind = case["kind"]
            cfg = case_config(case) if "arch" in case else None
            if kind == "train":
                params = case_params(work, case)
                with R.Keeps() as k:
                    out[name] = run_steps(cfg, params, mesh)
                out[name]["routes"] = k.ids
                out[name]["loss0"], out[name]["grads"] = first_grads(cfg, params, mesh)
            elif kind == "control":
                params = load(work, case["arch"])
                with TPControl(case["control"]):
                    res = R.run_steps(cfg, params, mesh, R.optimizer())
                    _, grads = first_grads(cfg, params, mesh)
                out[name] = dict(losses=res["losses"], state=res["state"], grads=grads)
            elif kind == "serve":
                served = serve_mod.serve(cfg, params=case_params(work, case, "_serve"),
                                         mesh=mesh, device="cpu", **R.SERVE)
                out[name] = dict(generated=served["generated"], logits=served["prefill_logits"],
                                 at_rest=served["at_rest_bytes"])
            elif kind == "fg":
                out[name] = f_and_g(mesh)
            elif kind == "ckpt":  # checkpoints every 2 steps into work/<dir>, or resumes
                kw = dict(global_batch=BATCH, seq_len=SEQ, mesh=mesh, opt=R.optimizer(),
                          params=load(work, case["arch"]), device="cpu")
                d = os.path.join(work, case["dir"])
                rep = train_mod.train(cfg, steps=case["steps"], ckpt_dir=d, ckpt_every=2, **kw)
                out[name] = dict(losses=rep["losses"], final_step=rep["final_step"])
                if case.get("whole"):
                    out[name]["whole"] = train_mod.train(cfg, steps=case["whole"], **kw)["losses"]
        torch.save(out, os.path.join(work, f"world{world}_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
