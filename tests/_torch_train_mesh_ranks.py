"""The rank program of ``tests/test_torch_train_mesh.py``, and the steps it
shares with the test's one-device runs.

Run as ``python _torch_train_mesh_ranks.py RANK WORLD WORKDIR``: the ranks
meet through a gloo ``FileStore`` in WORKDIR, read ``cases.json`` and each
case's initial parameters (``<arch>.npz``, the JAX package's init converted;
the port's seeded init for a case that changes the number of periods) and
route ids (``*.pt``) from it, run every case of their world on the CPU (on
the world's mesh, or a (data, model) mesh the case names), and write what
they got to ``world<WORLD>_rank<RANK>.pt``.  Nothing here imports JAX.
"""

import dataclasses
import datetime
import json
import os
import sys

import numpy as np
import torch

from repro_torch import configs
from repro_torch.data import lm as lm_data
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import train as train_mod
from repro_torch.models import moe
from repro_torch.models import model as M
from repro_torch.models.model import Transformer
from repro_torch.optim import AdamW
from repro_torch.runtime.data_parallel import DataParallelPlan

STEPS, BATCH, SEQ = 3, 4, 16
SERVE = dict(batch=BATCH, prompt_len=SEQ, gen_tokens=4, seed=0)


def config(case):
    """The reduced config of a case: its arch, with ``dispatch`` and the MoE
    ``capacity`` factor replaced where the case names them, ``periods`` periods,
    and ``remat`` ``"full"``, ``"dots"`` or ``"off"``."""
    cfg = configs.get_reduced(case["arch"])
    if case.get("dispatch"):
        cfg = dataclasses.replace(cfg, moe=cfg.moe._replace(dispatch=case["dispatch"]))
    if case.get("capacity") is not None:
        cfg = dataclasses.replace(cfg, moe=cfg.moe._replace(capacity_factor=case["capacity"]))
    if case.get("periods"):
        cfg = dataclasses.replace(cfg, n_periods=case["periods"])
    if case.get("remat"):
        off = case["remat"] == "off"
        cfg = dataclasses.replace(cfg, remat=not off,
                                  remat_policy="full" if off else case["remat"])
    return cfg


def optimizer(case=None):
    """The cases' AdamW; a case with ``"clip": null`` runs unclipped (a
    clipped step is the same whatever the gradients' common scale)."""
    clip = (case or {}).get("clip", 1.0)
    return AdamW(peak_lr=1e-3, warmup_steps=1, total_steps=6, clip_norm=clip)


def pipe(cfg):
    return lm_data.PipelineConfig(vocab_size=cfg.vocab_size, seq_len=SEQ + 1,
                                  global_batch=BATCH, seed=0)


def load_params(work, arch):
    with np.load(os.path.join(work, f"{arch}.npz")) as f:
        return {k: torch.from_numpy(f[k]) for k in f.files}


def whole_gather_step(model, opt, plan):
    """A step that gathers every sharded leaf for the whole step, built from
    the plan's own pieces (``gather_params``: ``compute`` of every leaf;
    ``sync_grads`` after the backward; ``cut`` in the update): the schedule
    the per-period step replaced, which it must equal bit for bit."""

    def step(params, st, batch):
        with plan.scope():
            plan.gather_params(model, params)
            loss, grads = M.loss_and_grads(model, batch)
            grads = plan.sync_grads(grads)
            sq = plan.sq_norm(grads) if opt.clip_norm is not None else None
            params, st = opt.update(params, plan.moment_grads(grads), st, sq_norm=sq,
                                    block=plan.cut if plan.whole_moments else None)
            plan.release_params(model)
            return plan.mean_loss(loss.detach()), params, st

    return step


def run_steps(cfg, params, mesh, opt, steps=STEPS, batch_fn=None, whole=False):
    """The training entry point's pieces (``make_sharded_train_state``,
    ``make_step`` or, ``whole``, :func:`whole_gather_step`,
    ``batch_for_mesh``, or ``batch_fn(step)`` for this rank's batch) for
    ``steps`` steps: the
    losses, this rank's collective bytes, the expected ones, the plan's
    held-bytes peak over the steps, its bound and the whole-step figure,
    and the full state afterwards as numpy (``p/``, ``mu/``, ``nu/`` +
    name; an 8-bit moment's int8 blocks and scales under ``/q`` and
    ``/scale``)."""
    model, p, st, plan = train_mod.make_sharded_train_state(cfg, opt, mesh, device="cpu",
                                                            params=params)
    step = (whole_gather_step if whole else train_mod.make_step)(model, opt, plan)
    axes = ("data",) if mesh is None else M.batch_axes(mesh)
    losses = []
    plan.comm.reset()
    plan.reset_held()
    for i in range(steps):
        batch = (batch_fn(i) if batch_fn else
                 {"tokens": lm_data.batch_for_mesh(pipe(cfg), i, mesh, axes, device="cpu")})
        loss, p, st = step(p, st, batch)
        losses.append(float(loss))
    issued = dict(plan.comm.bytes)
    want = {k: steps * v for k, v in plan.collective_bytes("train", BATCH, SEQ).items()
            if k != "total"}
    full = plan.full_state({"params": p, "mu": st.mu, "nu": st.nu})
    state = {}
    for part in ("params", "mu", "nu"):
        for k, v in full[part].items():
            for sub, t in (zip(("/q", "/scale"), v) if isinstance(v, tuple) else (("", v),)):
                state[f"{part}/{k}{sub}"] = t.detach().cpu().numpy().copy()
    return dict(losses=losses, issued=issued, want=want, state=state, at_rest=plan.at_rest_bytes(),
                held_peak=plan.held_peak, held_bound=plan.held_bound(),
                whole_step=plan.whole_step_bytes(), per_period=len(plan.per_period))


def per_period_pair(cfg, params, mesh, opt, batch_fn=None):
    """The per-period step's run and the whole-gather step's from the same
    parameters and batches (:func:`run_steps`)."""
    return dict(pp=run_steps(cfg, params, mesh, opt, batch_fn=batch_fn),
                whole=run_steps(cfg, params, mesh, opt, batch_fn=batch_fn, whole=True))


def check_per_period(pair):
    """The per-period step against the whole-gather step (one rank's
    :func:`per_period_pair`): its losses and every parameter and moment
    bit for bit, collectives issued equal to its plan's, its held-bytes
    peak within the plan's bound, and the whole-gather step's at the whole
    step's figure, above the bound."""
    pp, whole = pair["pp"], pair["whole"]
    assert pp["per_period"] > 0
    assert pp["losses"] == whole["losses"]
    assert set(pp["state"]) == set(whole["state"])
    for k, v in pp["state"].items():
        assert v.tobytes() == whole["state"][k].tobytes(), k
    assert pp["issued"] == pp["want"]
    assert 0 < pp["held_peak"] <= pp["held_bound"] < whole["held_peak"] == pp["whole_step"]


class Keeps:
    """While entered: every ``moe.dispatch_plan`` call's kept-pair mask in
    ``keeps``; with ``replay`` (a list of expert ids), ``moe.route`` hands
    those ids back in order."""

    def __init__(self, replay=None):
        self.keeps, self.ids = [], []
        self.replay = None if replay is None else iter(replay)

    def __enter__(self):
        self._plan, self._route = moe.dispatch_plan, moe.route

        def plan(*args):
            out = self._plan(*args)
            self.keeps.append(out.keep.clone())
            return out

        def route(h, router, dims):
            probs, gates, eidx = self._route(h, router, dims)
            if self.replay is not None:
                eidx = next(self.replay)
                gates = moe.gates_at(probs, eidx)
            self.ids.append(eidx)
            return probs, gates, eidx

        moe.dispatch_plan, moe.route = plan, route
        return self

    def __exit__(self, *exc):
        moe.dispatch_plan, moe.route = self._plan, self._route


def moe_block_input(cfg, batch=BATCH, seq=SEQ):
    """A fixed (batch, seq, d_model) input for one MoE block."""
    x = np.random.default_rng(7).standard_normal((batch, seq, cfg.d_model)).astype(np.float32)
    return torch.from_numpy(x)


def moe_block(cfg, params):
    """The first MoE block of ``cfg`` holding ``params``."""
    model = Transformer.from_params(cfg, params, device="cpu")
    return next(b for b in model.blocks if isinstance(b, moe.MoE))


def moe_aux_and_grads(blk, x):
    """A MoE block's output, aux loss and the aux's gradients (router,
    norm scale) on ``x`` under the active mesh and token split."""
    out, aux = blk(x)
    grads = torch.autograd.grad(aux, [blk.router, blk.norm_scale])
    return out.detach(), aux.detach(), [g.detach() for g in grads]


def main(rank, world, work):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    with open(os.path.join(work, "cases.json")) as f:
        spec = json.load(f)[str(world)]
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(work, f"store{world}"),
                                                         world),
                            rank=rank, world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = init_device_mesh("cpu", tuple(spec["shape"]), mesh_dim_names=tuple(spec["axes"]))
        other = {}
        out = {}
        for case in spec["cases"]:
            cfg = config(case)
            params = None if case.get("periods") else load_params(work, case["arch"])
            name = case["name"]
            if case["kind"] == "per_period":  # on the case's (data, model) mesh
                shape = tuple(case["mesh"])
                if shape not in other:  # every rank builds them in the same order
                    other[shape] = init_device_mesh("cpu", shape,
                                                    mesh_dim_names=("data", "model"))
                out[name] = per_period_pair(cfg, params, other[shape], optimizer(case))
            elif case["kind"] == "train":
                out[name] = run_steps(cfg, params, mesh, optimizer(case))
                if case.get("driver"):  # the entry point runs the same steps
                    rep = train_mod.train(cfg, steps=STEPS, global_batch=BATCH, seq_len=SEQ,
                                          mesh=mesh, opt=optimizer(), params=params,
                                          device="cpu")
                    out[name]["driver"] = dict(losses=rep["losses"],
                                               issued=rep["collective_bytes"])
            elif case["kind"] == "keeps":  # the global plan's kept pairs, routes replayed
                plan = DataParallelPlan(cfg, M.abstract_params(cfg), mesh)
                lo, n = plan.rows(BATCH)
                ids = torch.load(os.path.join(work, f"{name}_ids.pt"))
                mine = [e[lo * SEQ:(lo + n) * SEQ] for e in ids]
                toks = lm_data.global_batch_at(pipe(cfg), 0)[lo:lo + n, :-1]
                model = Transformer.from_params(cfg, params, device="cpu")
                with Keeps(replay=mine) as k, torch.no_grad(), plan.scope():
                    model(torch.from_numpy(toks).long())
                out[name] = dict(keeps=k.keeps, rows=(lo, n))
            elif case["kind"] == "block":  # one MoE block: output, aux and its gradient
                plan = DataParallelPlan(cfg, M.abstract_params(cfg), mesh)
                lo, n = plan.rows(BATCH)
                blk = moe_block(cfg, params)
                with plan.scope():
                    y, aux, grads = moe_aux_and_grads(blk, moe_block_input(cfg)[lo:lo + n])
                    layout = moe.layout(n * SEQ, cfg.moe, plan.world)
                for g in grads:  # the drivers' average over the ranks
                    plan.comm.all_reduce(g, plan.batch_group).div_(plan.world)
                out[name] = dict(out=y, aux=aux, grads=grads, rows=(lo, n),
                                 layout=tuple(layout))
            elif case["kind"] == "serve":  # every rank gets the whole batch's tokens
                served = serve_mod.serve(cfg, params=params, mesh=mesh, device="cpu", **SERVE)
                out[name] = dict(generated=served["generated"],
                                 logits=served["prefill_logits"])
            elif case["kind"] == "ckpt":
                kw = dict(global_batch=BATCH, seq_len=SEQ, mesh=mesh, opt=optimizer(),
                          params=params, device="cpu")
                d = os.path.join(work, "ck2")
                first = train_mod.train(cfg, steps=4, ckpt_dir=d, ckpt_every=2, **kw)
                resumed = train_mod.train(cfg, steps=2, ckpt_dir=d, ckpt_every=2, **kw)
                whole = train_mod.train(cfg, steps=6, **kw)
                # a one-device checkpoint at step 2 (the test's), resumed here
                from_one = train_mod.train(cfg, steps=2, ckpt_dir=os.path.join(work, "ck1"),
                                           ckpt_every=2, **kw)
                out[name] = dict(first=first["losses"], resumed=resumed["losses"],
                                 final_step=resumed["final_step"], whole=whole["losses"],
                                 from_one=from_one["losses"],
                                 from_one_step=from_one["final_step"])
        torch.save(out, os.path.join(work, f"world{world}_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
