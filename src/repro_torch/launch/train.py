"""Training entry point of the LM (every token-frontend family): config +
data pipeline + AdamW + fault tolerance, on one device or over a mesh.

Counterpart of ``src/repro/launch/train.py``::

    config -> init params (random, from the seed; sharded) -> deterministic
    token pipeline -> train step (gathers, loss, gradients, their sync --
    a period at a time on a data axis -- AdamW on the shards) -> TrainLoop
    (async checkpoints, resume, straggler detection)

The reference runs one program on a device mesh under GSPMD
(``make_sharded_train_state``, ``make_step``, ``batch_for_mesh``).  The port
runs one process a rank over ``torch.distributed``
(:mod:`repro_torch.runtime.data_parallel`): every rank builds the same model
from the seed, keeps between steps only its blocks of the leaves that
``param_specs`` / ``AdamW.state_specs`` cut over ``data`` (parameters and
moments), takes its rows of the ``(seed, step)`` batch, and averages the
gradients over the ranks.  ``mesh=None``, or a ``DeviceMesh`` of world 1
such as ``launch.mesh.make_local_mesh()``, is one device: no collective, and
the same bits either way.  Meshes of ``pod`` x ``data`` x ``model`` ranks
run: a ``model`` axis larger than 1 cuts heads, FFN columns, experts, the
SSM mixers' channels and heads and the vocabulary over its ranks, Megatron-style
(:mod:`repro_torch.runtime.tensor_parallel`), and the ranks of a model group
share rows and losses.  On the card every attention layer's forward
launches the hand-written flash kernel at the rank's heads (twice a step
under remat: the forward and its recompute); the backward is plain
PyTorch.  The pipeline yields tokens only, as the
reference's does: a frames encoder (HuBERT) trains through
``models.model.make_train_step`` on a batch of ``frames`` and ``labels``.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b --reduced \\
        --device cpu --steps 20 --batch 2 --seq 32 --ckpt-dir /tmp/run1
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --arch qwen2-1.5b --reduced --device cpu --steps 20 --batch 4 --seq 32   # 2 gloo ranks
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch qwen2-1.5b --reduced --device cpu --steps 20 --batch 4 --seq 32 \\
        --model-parallel 2                                 # (data 2, model 2)
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
        --steps 8 --batch 4 --seq 1024                                  # on the card
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional

import torch

from .. import configs
from ..data import lm as lm_data
from ..models import model as M
from ..optim import AdamW
from ..runtime import TrainLoop, TrainLoopConfig
from ..runtime.data_parallel import DataParallelPlan, mesh_device
from . import mesh as mesh_mod


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def make_sharded_train_state(cfg, opt: AdamW, mesh, seed: int = 0, *, device=None,
                             params: Optional[Dict] = None):
    """The model from ``seed`` (or ``params``, a state dict), this rank's
    parameters and optimizer state cut by the plan, and the plan:
    ``(model, params, opt_state, plan)``.  Between steps the model holds no
    full tensor of a sharded leaf; a leaf cut over a model axis is held as
    this rank's block."""
    dev = mesh_device(mesh, device, cfg)
    if params is None:
        model = M.Transformer(cfg, device=dev, seed=seed)
    else:
        model = M.Transformer.from_params(cfg, params, device=dev)
    plan = DataParallelPlan(cfg, model, mesh, opt)
    params = plan.shard_params(model)
    return model, params, plan.init_state(params), plan


def make_step(model, opt: AdamW, plan: DataParallelPlan):
    """``step(params, opt_state, batch) -> (loss, params, opt_state)`` on this
    rank's rows: ``plan.loss_and_grads`` (``models.model.loss_and_grads``,
    the one-device step's body, on the gathered leaves: on a data axis
    larger than 1 each period's gathered inside it, and its gradients
    averaged over the ranks as its backward ends; the others gathered for
    the step and averaged after it), the full tensors freed, the clip scale
    from the global norm, AdamW on this rank's blocks (8-bit moments on a
    model axis: on the whole leaves' gathered gradients, the update cut to
    the blocks).  ``loss`` is the ranks' mean, detached."""

    def train_step(params, opt_state, batch):
        with plan.scope():
            loss, grads = plan.loss_and_grads(model, params, batch)
            plan.release_params(model)  # the update needs only the blocks
            sq = plan.sq_norm(grads) if opt.clip_norm is not None else None
            params, opt_state = opt.update(params, plan.moment_grads(grads), opt_state,
                                           sq_norm=sq,
                                           block=plan.cut if plan.whole_moments else None)
            return plan.mean_loss(loss.detach()), params, opt_state

    return train_step


def train(
    cfg,
    *,
    steps: int = 100,
    global_batch: int = 8,
    seq_len: int = 128,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 50,
    mesh=None,
    seed: int = 0,
    log_every: int = 10,
    opt: Optional[AdamW] = None,
    device=None,
    params: Optional[Dict] = None,
) -> Dict[str, Any]:
    """Train ``cfg`` from random weights (``seed``; ``params``, a state dict
    such as :func:`repro_torch.convert.lm_params_from_reference`'s, replaces
    them) for ``steps`` steps of ``global_batch`` sequences of ``seq_len``
    tokens, on ``mesh``'s ranks (every rank calls it).  With ``ckpt_dir`` the
    steps run in a :class:`~repro_torch.runtime.TrainLoop` that resumes from
    the newest checkpoint there and saves every ``ckpt_every`` steps.

    Returns the loop's report plus ``losses`` (one a step run: the batch
    ranks' mean), ``step_seconds`` (host time of each step, which ends in reading
    its loss), ``collective_bytes`` and ``collective_seconds`` (this rank's
    collectives, checkpoints' gathers included)."""
    if cfg.frontend != "tokens":
        raise ValueError(f"{cfg.name}: the token pipeline cannot feed a {cfg.frontend!r} "
                         "frontend; train it through models.model.make_train_step")
    dev = mesh_device(mesh, device, cfg)
    opt = opt or AdamW(peak_lr=3e-4, warmup_steps=min(50, steps // 10 + 1),
                       total_steps=steps)
    model, params, opt_state, plan = make_sharded_train_state(cfg, opt, mesh, seed,
                                                              device=device, params=params)
    step_fn = make_step(model, opt, plan)
    pipe = lm_data.PipelineConfig(vocab_size=cfg.vocab_size, seq_len=seq_len + 1,
                                  global_batch=global_batch, seed=seed)
    axes = ("data",) if mesh is None else M.batch_axes(mesh)
    live = {"params": params}
    losses, step_seconds = [], []
    state = {"params": params, "opt": opt_state}

    def batch_fn(step: int):
        return {"tokens": lm_data.batch_for_mesh(pipe, step, mesh, axes, device=dev)}

    def wrapped_step(state, batch):
        if state["params"] is not live["params"]:  # a restore replaced the tree
            live["params"] = plan.adopt(model, state["params"])
        t0 = time.perf_counter()
        loss, live["params"], opt_state = step_fn(live["params"], state["opt"], batch)
        loss = float(loss)  # waits for the step
        step_seconds.append(time.perf_counter() - t0)
        losses.append(loss)
        return {"params": live["params"], "opt": opt_state}, {"loss": loss}

    plan.comm.reset()
    if ckpt_dir is not None:
        loop = TrainLoop(TrainLoopConfig(ckpt_dir=ckpt_dir, ckpt_every=ckpt_every),
                         wrapped_step, batch_fn, state, sharding=plan)
        loop.try_resume()
        report = loop.run(steps)
    else:
        t0 = time.perf_counter()
        for i in range(steps):
            state, m = wrapped_step(state, batch_fn(i))
            if i % log_every == 0 and plan.writer:
                print(f"step {i:5d} loss {m['loss']:.4f}", flush=True)
        _sync(dev)
        report = {"final_step": steps, "seconds": time.perf_counter() - t0}
    report["losses"] = losses
    report["step_seconds"] = step_seconds
    report["collective_bytes"] = dict(plan.comm.bytes)
    report["collective_seconds"] = plan.comm.seconds
    return report


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", type=str, default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="ranks of the mesh's model axis under a launcher")
    args = ap.parse_args(argv)

    cfg = configs.get_reduced(args.arch) if args.reduced else configs.get_config(args.arch)
    mesh = mesh_mod.launcher_mesh(device=args.device, model_parallel=args.model_parallel)
    report = train(cfg, steps=args.steps, global_batch=args.batch, seq_len=args.seq,
                   ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, seed=args.seed,
                   mesh=mesh, device=args.device)
    losses = report["losses"]
    print(f"done: {report.get('final_step')} steps; "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return report


if __name__ == "__main__":
    main()
