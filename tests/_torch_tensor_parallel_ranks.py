"""The rank program of ``tests/test_torch_tensor_parallel.py``.

and of ``tests/test_torch_tensor_parallel_ssm.py``.

Run as ``python _torch_tensor_parallel_ranks.py RANK WORLD WORKDIR``: the
ranks meet through a gloo ``FileStore`` in WORKDIR, read ``cases.json`` and
each case's initial parameters (``<arch>.npz``, or the case's ``params``
name, for training: the JAX package's jitted init converted;
``<arch>_serve.npz`` for serving, its eager init, as its ``serve`` draws
them), run every case of their world on the
meshes the cases name (``(data, model)``, row-major, the model index
fastest: ``make_local_mesh(model_parallel=k)``'s layout), and write what
they got to ``world<WORLD>_rank<RANK>.pt``.  Nothing here imports JAX.
"""

import dataclasses
import datetime
import json
import os
import sys
import time

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
    one, the chunked CE where it names a ``ce_chunk``, and its ``vocab``
    where it names one."""
    cfg = R.config(case)
    if case.get("ce_chunk"):
        cfg = dataclasses.replace(cfg, ce_impl="chunked", ce_chunk=case["ce_chunk"])
    if case.get("vocab"):
        cfg = dataclasses.replace(cfg, vocab_size=case["vocab"])
    return cfg


def optimizer(case):
    """The cases' AdamW (``R.optimizer``'s), with 8-bit moments where the
    case says ``int8``."""
    return dataclasses.replace(R.optimizer(case), quantize_states=bool(case.get("int8")))


def frames_batch(cfg, step):
    """The global batch of a frames config at ``step``: ``frame_embeddings``
    (the reference's values, seed 0) and labels drawn from ``step``, numpy."""
    frames = lm_data.frame_embeddings(cfg.d_model, SEQ, BATCH, seed=0, step=step,
                                      device="cpu").numpy()
    labels = np.random.default_rng(step).integers(0, cfg.vocab_size, (BATCH, SEQ))
    return frames, labels


def batch_at(cfg, step, mesh):
    """This rank's rows of the batch at ``step``: tokens, or a frames
    config's frames and labels (every row with ``mesh=None``)."""
    axes = ("data",) if mesh is None else M.batch_axes(mesh)
    if cfg.frontend == "tokens":
        return {"tokens": lm_data.batch_for_mesh(R.pipe(cfg), step, mesh, axes, device="cpu")}
    lo, n = (0, BATCH) if mesh is None else train_mod.DataParallelPlan(
        cfg, M.abstract_params(cfg), mesh).rows(BATCH)
    frames, labels = frames_batch(cfg, step)
    return {"frames": torch.from_numpy(frames[lo:lo + n]),
            "labels": torch.from_numpy(labels[lo:lo + n]).long()}


def load(work, name, wait_s=180):
    """``WORKDIR/<name>.npz``'s tensors, waiting up to ``wait_s`` for the file
    (a test may write it while the ranks run their earlier cases; it moves
    each file into place whole)."""
    path = os.path.join(work, f"{name}.npz")
    deadline = time.monotonic() + wait_s
    while not os.path.exists(path) and time.monotonic() < deadline:
        time.sleep(0.05)
    with np.load(path) as f:
        return {k: torch.from_numpy(f[k]) for k in f.files}


def case_params(work, case, suffix=""):
    """The case's initial parameters, or None for the port's seeded init."""
    return None if case.get("random") else load(work, case.get("params", case["arch"]) + suffix)


def _numpy(tree):
    return {k: v.detach().cpu().numpy().copy() for k, v in tree.items()}


def first_grads(cfg, params, mesh):
    """Step 0's gradients on this rank's rows, synchronised by the plan
    (averaged over the batch ranks, summed where a model rank holds them in
    part) and gathered into the one-device layout, and the loss."""
    opt = R.optimizer()
    model, p, _, plan = train_mod.make_sharded_train_state(cfg, opt, mesh, device="cpu",
                                                           params=params)
    batch = batch_at(cfg, 0, mesh)
    with plan.scope():
        loss, grads = plan.loss_and_grads(model, p, batch)
        plan.release_params(model)
    return float(plan.mean_loss(loss.detach())), _numpy(plan.full_state({"g": grads})["g"])


def _moment_tensors(moments):
    for v in moments.values():
        yield from (v if isinstance(v, tuple) else (v,))


def run_steps(cfg, params, mesh, opt=None):
    """:func:`_torch_train_mesh_ranks.run_steps` (on :func:`batch_at`'s
    batches) plus the bytes this rank holds between steps (its parameter and
    moment tensors, an 8-bit moment's int8 blocks and scales)."""
    opt = opt or R.optimizer()
    model, p, st, plan = train_mod.make_sharded_train_state(cfg, opt, mesh, device="cpu",
                                                            params=params)
    held = sum(t.numel() * t.element_size() for t in [*p.values(), *_moment_tensors(st.mu),
                                                        *_moment_tensors(st.nu)])
    out = R.run_steps(cfg, params, mesh, opt, batch_fn=lambda i: batch_at(cfg, i, mesh))
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


def two_way_sum(mesh):
    """``tensor_parallel.sum_over_model`` on the model group of ``mesh``, as
    :func:`f_and_g` runs ``f`` and ``g``."""
    plan = train_mod.DataParallelPlan(configs.get_reduced("qwen2-1.5b"),
                                      M.abstract_params(configs.get_reduced("qwen2-1.5b")),
                                      mesh)
    r = plan.model_index
    x = (torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10.0 * r).requires_grad_(True)
    with plan.scope():
        y = tp.sum_over_model(x)
        (gx,) = torch.autograd.grad(y, x, grad_outputs=torch.full((2, 3), 1.0 + r))
    return dict(y=y.detach(), grad=gx, issued=dict(plan.comm.bytes))


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
                    out[name] = run_steps(cfg, params, mesh, optimizer(case))
                out[name]["routes"] = k.ids
                out[name]["loss0"], out[name]["grads"] = first_grads(cfg, params, mesh)
            elif kind == "per_period":  # against the whole-gather step
                out[name] = R.per_period_pair(cfg, case_params(work, case), mesh,
                                              optimizer(case),
                                              batch_fn=lambda i: batch_at(cfg, i, mesh))
            elif kind == "control":
                params = case_params(work, case)
                with TPControl(case["control"]):
                    res = run_steps(cfg, params, mesh)
                    _, grads = first_grads(cfg, params, mesh)
                out[name] = dict(losses=res["losses"], state=res["state"], grads=grads)
            elif kind == "serve":
                served = serve_mod.serve(cfg, params=case_params(work, case, "_serve"),
                                         mesh=mesh, device="cpu", **R.SERVE)
                out[name] = dict(generated=served["generated"], logits=served["prefill_logits"],
                                 at_rest=served["at_rest_bytes"])
            elif kind == "fg":
                out[name] = f_and_g(mesh)
            elif kind == "sum":
                out[name] = two_way_sum(mesh)
            elif kind == "ckpt":  # checkpoints every 2 steps into work/<dir>, or resumes
                kw = dict(global_batch=BATCH, seq_len=SEQ, mesh=mesh, opt=optimizer(case),
                          params=case_params(work, case), device="cpu")
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
