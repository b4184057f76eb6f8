"""Training entry point of the LM (every token-frontend family): config +
data pipeline + AdamW + fault tolerance, on one device.

Counterpart of ``src/repro/launch/train.py``::

    config -> init params (random, from the seed) -> deterministic token
    pipeline -> train step (loss, gradients, AdamW in place) -> TrainLoop
    (async checkpoints, resume, straggler detection)

The reference runs the same code on a device mesh under GSPMD
(``param_specs``/``batch_specs``); the port trains on one device
(``mesh=None``, or a ``DeviceMesh`` of world 1 such as
``launch.mesh.make_local_mesh()``, under which the steps run inside
``models.hints.use_mesh``, the reference's ``with mesh:``; a world of one
gives the same bits as no mesh).  Data-parallel and sharded training over
``torch.distributed`` is ROADMAP item 14i.  On the card every
attention layer's forward launches the hand-written flash kernel (twice a
step under remat: the forward and its recompute); the backward is plain
PyTorch.  The pipeline yields tokens only, as the reference's does: a frames
encoder (HuBERT) trains through ``models.model.make_train_step`` on a batch
of ``frames`` and ``labels``.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b --reduced \\
        --device cpu --steps 20 --batch 2 --seq 32 --ckpt-dir /tmp/run1
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
        --steps 8 --batch 4 --seq 1024                                  # on the card
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional

import torch

from .. import _device, configs
from ..data import lm as lm_data
from ..models import hints
from ..models import model as M
from ..optim import AdamW
from ..runtime import TrainLoop, TrainLoopConfig

_MULTI_DEVICE = ("training over a device mesh of more than one device (data-parallel "
                 "and sharded training over torch.distributed) is ROADMAP item 14i")


def mesh_device(mesh, device=None) -> torch.device:
    """The one device training runs on: ``device`` without a mesh, the
    device of a ``DeviceMesh`` of world 1; a larger mesh raises."""
    if mesh is None:
        return _device.resolve(device)
    if mesh.size() > 1:
        raise NotImplementedError(_MULTI_DEVICE)
    dev = _device.resolve(mesh.device_type)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


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
) -> Dict[str, Any]:
    """Train ``cfg`` from random weights (``seed``) for ``steps`` steps of
    ``global_batch`` sequences of ``seq_len`` tokens.  With ``ckpt_dir`` the
    steps run in a :class:`~repro_torch.runtime.TrainLoop` that resumes from
    the newest checkpoint there and saves every ``ckpt_every`` steps.

    Returns the loop's report plus ``losses`` (one a step run) and
    ``step_seconds`` (host time of each step, which ends in reading its
    loss)."""
    if cfg.frontend != "tokens":
        raise ValueError(f"{cfg.name}: the token pipeline cannot feed a {cfg.frontend!r} "
                         "frontend; train it through models.model.make_train_step")
    dev = mesh_device(mesh, device)
    opt = opt or AdamW(peak_lr=3e-4, warmup_steps=min(50, steps // 10 + 1),
                       total_steps=steps)
    model = M.Transformer(cfg, device=dev, seed=seed)
    live = dict(model.named_parameters())
    step_fn = M.make_train_step(opt)
    pipe = lm_data.PipelineConfig(vocab_size=cfg.vocab_size, seq_len=seq_len + 1,
                                  global_batch=global_batch, seed=seed)

    losses, step_seconds = [], []
    state = {"params": live, "opt": opt.init(live)}

    def batch_fn(step: int):
        return {"tokens": lm_data.batch_for_device(pipe, step, dev)}

    def wrapped_step(state, batch):
        if state["params"] is not live:  # a restore replaced the tree
            model.load_params(state["params"])
            state = {"params": live, "opt": state["opt"]}
        t0 = time.perf_counter()
        loss, opt_state = step_fn(model, state["opt"], batch)
        loss = float(loss)  # waits for the step
        step_seconds.append(time.perf_counter() - t0)
        losses.append(loss)
        return {"params": live, "opt": opt_state}, {"loss": loss}

    with hints.use_mesh(mesh):
        if ckpt_dir is not None:
            loop = TrainLoop(TrainLoopConfig(ckpt_dir=ckpt_dir, ckpt_every=ckpt_every),
                             wrapped_step, batch_fn, state)
            loop.try_resume()
            report = loop.run(steps)
        else:
            t0 = time.perf_counter()
            for i in range(steps):
                state, m = wrapped_step(state, batch_fn(i))
                if i % log_every == 0:
                    print(f"step {i:5d} loss {m['loss']:.4f}", flush=True)
            _sync(dev)
            report = {"final_step": steps, "seconds": time.perf_counter() - t0}
    report["losses"] = losses
    report["step_seconds"] = step_seconds
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
    args = ap.parse_args(argv)

    cfg = configs.get_reduced(args.arch) if args.reduced else configs.get_config(args.arch)
    report = train(cfg, steps=args.steps, global_batch=args.batch, seq_len=args.seq,
                   ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, seed=args.seed,
                   device=args.device)
    losses = report["losses"]
    print(f"done: {report.get('final_step')} steps; "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return report


if __name__ == "__main__":
    main()
