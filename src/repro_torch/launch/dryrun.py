"""Dry run: build every (arch x shape) cell on the ``meta`` device against the
production mesh's sharding rules, and count what its step does.

Counterpart of ``src/repro/launch/dryrun.py``.  The reference lowers and
compiles each cell for 256 or 512 fake host devices; eager PyTorch has no
compiler and no partitioner, so the port runs each cell's step once on
``meta`` tensors (shapes and types, no storage, nothing computed) under an
:class:`~repro_torch.launch.mesh.AbstractMesh` (axis names and sizes, no
devices).  It never initializes CUDA and runs on a machine without a card.
For each cell:

* ``lower_cell`` builds the model (``models.model.abstract_params``), its
  specs (``param_specs``, ``batch_specs``, ``cache_specs``,
  ``AdamW.state_specs``), the step's inputs (``configs.input_specs``) and
  the step: train (loss, gradients, AdamW update), prefill or decode;
* ``run_cell`` runs the step once under ``torch.utils.flop_counter.
  FlopCounterMode`` and a byte counter, with the config's ``unroll_scan``
  set as the reference's ``_cost_compile`` sets it (which, in eager code,
  changes only the sLSTM, to its FLOP-equivalent parallel form), and keeps
  the reference record's keys.

What each number is:

* ``flops_total``: FlopCounterMode's count of the whole step, every period
  (eager code runs every period, so no 1- and 2-period difference is
  needed).  It counts the matmul-class ops (``mm``, ``bmm``, ``addmm``,
  ``baddbmm``, convolutions, fused attention) and not elementwise work.
  ``flops`` is ``flops_total / devices``: the reference's ``flops`` is per
  device (XLA's per-partition cost), and an even split is the plan's share.
* ``bytes_accessed_total``: every dispatched op's operand and result bytes
  (views, which move nothing, excluded); ``bytes_accessed`` per device as
  ``flops``.
* ``flops_raw``, ``bytes_raw``, ``collective_bytes_raw``: the reference's
  record keys for its production module's counts before the per-period
  correction; eager code needs none, so they repeat ``flops``,
  ``bytes_accessed`` and ``collective_bytes``, kept so that one reader
  takes both packages' records.
* ``memory.argument_size_bytes`` / ``output_size_bytes``: per device, each
  leaf's bytes divided by the mesh sizes its spec names (after the
  divisibility fix).
* ``temp_size_bytes``, ``generated_code_size_bytes``, ``time_compile_s``:
  only a compiler can give them, so they are ``null``; ``why`` says so for
  each.
* ``collective_bytes``: the result bytes a device's collectives receive in
  the step under the port's plan
  (:class:`repro_torch.runtime.data_parallel.DataParallelPlan`, the object
  the training and serving drivers run), by kind.  Over the ``pod`` and
  ``data`` axes: a train step's parameter all_gathers (a period's leaf
  gathered inside the period and again by its remat recompute, as the
  reference's scanned step gathers it), gradient reduce_scatters and
  all_reduces (each leaf at the bytes of its block over
  the ``model`` axis, 16 on the production mesh) and its two scalars, and
  every cell's MoE all_reduces (the aux loss) and all_gathers (the global
  plan's counts).  Over the ``model`` axis, the Megatron plan of
  :mod:`repro_torch.runtime.tensor_parallel`: each sub-block's and a cut
  vocabulary's embedding ``all_reduce`` of a rank's activations (again
  under remat), the SSM mixers' two-way sums, in training the ``f``'s
  backward ones and a cut vocabulary's CE reductions, in serving its
  logits' gather, and the gathered and partial leaves' collectives.  A
  config whose heads or channels the model axis does not divide
  (xLSTM-1.3B's 4 heads over 16, Qwen2-1.5B's 12) does not run on it: its
  counts there are the plan's as if it did, and ``why`` names the count.  The reference's counts are
  GSPMD's, another plan over the same axes
  (``tests/test_torch_tensor_parallel.py`` puts both side by side on a
  reduced step), so the two differ.  No HLO is parsed here.

``run_oavi_cell`` is the paper's degree step (m = 4,194,304, n = 57,
L = 256, K = 64) on ``meta``, at the rows of one device of the mesh; its
``collective_bytes`` is the port's own plan, ``core/distributed.py``'s one
``all_reduce`` of (QL, C) a degree.

Results go to ``results/dryrun_torch_<mesh>.json`` (the reference's
``dryrun_<mesh>.json`` stays its own).

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --oavi [--multi-pod]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from .. import configs
from ..models import hints
from ..models import model as M
from ..optim import AdamW
from ..runtime.data_parallel import DataParallelPlan
from . import mesh as mesh_mod

_COMPILER_ONLY = ("only an XLA compile reports it; the port's dry run compiles nothing "
                  "(eager PyTorch on meta tensors)")
_LM_PLAN = ("runtime/data_parallel.py DataParallelPlan.collective_bytes: the plan's "
            "collectives on the mesh's pod and data axes")
_MODEL_AXIS = ("; a leaf's bytes are those of its block over the model axis, what a device of "
               "this mesh moves over the data axes; over the model axis, the Megatron plan of "
               "runtime/tensor_parallel.py (sub-block, embedding and CE all_reduces, the "
               "gathered KV leaves, the served logits' gather), not GSPMD's")


class ByteCounter(TorchDispatchMode):
    """Sums each dispatched op's operand and result bytes (``numel *
    element_size`` of every tensor it takes or gives), views excluded: they
    move nothing."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.ops += 1
            self.bytes += _tensor_bytes((args, kwargs, out))
        return out


def _tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _spec_share(sizes: Dict[str, int], spec) -> int:
    """How many ways a leaf with ``spec`` is cut on the mesh."""
    n = 1
    for entry in spec:
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is not None:
                n *= sizes[axis]
    return n


def per_device_bytes(pairs: List[Tuple[torch.Tensor, Any]], mesh) -> int:
    """Bytes a device holds of ``(leaf, spec)`` pairs, each spec fitted to
    its leaf (the divisibility fix)."""
    sizes = hints.mesh_axis_sizes(mesh)
    total = 0
    for t, spec in pairs:
        spec = M.fit_spec(spec, t.shape, sizes)
        total += t.numel() * t.element_size() // _spec_share(sizes, spec)
    return total


def _cache_pairs(cache, specs) -> List[Tuple[torch.Tensor, Any]]:
    return [(t, s) for c, cs in zip(cache, specs) if c is not None for t, s in zip(c, cs)]


@dataclasses.dataclass
class Cell:
    """One cell built on meta: ``step()`` runs it once; ``arguments`` and
    ``outputs`` are its (leaf, spec) pairs, the reference's jit arguments
    and results."""
    step: Callable[[], Any]
    arguments: List[Tuple[torch.Tensor, Any]]
    outputs: List[Tuple[torch.Tensor, Any]]


def lower_cell(arch_id: str, shape_name: str, mesh, *, optimizer: Optional[AdamW] = None,
               cfg=None) -> Tuple[Cell, Dict[str, str]]:
    """Build one (arch, shape) cell on ``meta`` for ``mesh``.  Returns
    (cell, meta); an unsupported cell raises."""
    cfg = cfg or configs.get_config(arch_id)
    shape = configs.SHAPES[shape_name]
    ok, why = configs.cell_supported(cfg, shape)
    if not ok:
        raise ValueError(f"{arch_id} x {shape_name} skipped: {why}")

    model = M.abstract_params(cfg)
    params = dict(model.named_parameters())
    pspecs = M.param_specs(cfg, params, mesh)
    bspecs = M.batch_specs(cfg, mesh, shape.kind, shape.global_batch)
    batch = configs.input_specs(cfg, shape)
    param_pairs = [(params[k], pspecs[k]) for k in params]
    batch_pairs = [(batch[k], bspecs[k]) for k in batch]
    logits = torch.empty((shape.global_batch, 1, cfg.vocab_size), dtype=cfg.torch_dtype(),
                         device="meta")

    if shape.kind == "train":
        opt = optimizer or AdamW()
        state = opt.init(params)
        sspecs = opt.state_specs(pspecs)
        moments = [(t, s) for tree, specs in ((state.mu, sspecs.mu), (state.nu, sspecs.nu))
                   for k in params for t, s in _moment_leaves(tree[k], specs[k])]
        step_arg = [(torch.empty((), dtype=torch.int32, device="meta"), ())]
        train_step = M.make_train_step(opt)
        loss = torch.empty((), dtype=torch.float32, device="meta")
        cell = Cell(step=lambda: train_step(model, state, batch),
                    arguments=param_pairs + moments + step_arg + batch_pairs,
                    outputs=[(loss, ())] + param_pairs + moments + step_arg)
    elif shape.kind == "prefill":
        cache = M.abstract_cache(cfg, shape.global_batch, shape.seq_len)
        cache_pairs = _cache_pairs(cache, M.cache_specs(cfg, cache, mesh))
        inputs = batch["tokens" if cfg.frontend == "tokens" else "frames"]
        cell = Cell(step=lambda: model.prefill_inputs(inputs, shape.seq_len),
                    arguments=param_pairs + batch_pairs,
                    outputs=[(logits, ())] + cache_pairs)
    else:  # decode
        cache = M.abstract_cache(cfg, shape.global_batch, shape.seq_len)
        cache_pairs = _cache_pairs(cache, M.cache_specs(cfg, cache, mesh))
        cell = Cell(step=lambda: model.decode_step(cache, batch["token"], batch["pos"]),
                    arguments=param_pairs + cache_pairs + batch_pairs,
                    outputs=[(logits, ())] + cache_pairs)
    return cell, {"arch": arch_id, "shape": shape_name, "kind": shape.kind}


def _moment_leaves(moment, spec):
    """(leaf, spec) pairs of one parameter's moment: an fp32 tensor, or the
    quantized ``(int8 blocks, scale)`` pair."""
    if isinstance(moment, tuple):
        return list(zip(moment, spec))
    return [(moment, spec)]


def count_step(step: Callable[[], Any], mesh) -> Dict[str, Any]:
    """Run ``step`` once under the mesh, FlopCounterMode and the byte
    counter: (flops, bytes, ops, seconds)."""
    flops = FlopCounterMode(display=False)
    nbytes = ByteCounter()
    t0 = time.perf_counter()
    with hints.use_mesh(mesh), flops, nbytes:
        step()
    return {"flops": float(flops.get_total_flops()), "bytes": float(nbytes.bytes),
            "ops": nbytes.ops, "seconds": time.perf_counter() - t0}


def collective_why(plan: DataParallelPlan, mesh) -> str:
    """The ``why`` of an LM cell's ``collective_bytes``: the plan's axes, and
    on a model axis that the config's heads or channels do not split, the
    count that does not split (the counts are the plan's as if it did)."""
    why = _LM_PLAN
    if hints.mesh_axis_sizes(mesh).get("model", 1) > 1:
        why += _MODEL_AXIS
        if plan.refusal:
            why += (f"; {plan.refusal}: the config does not run on this mesh's model axis, "
                    "and its counts there are the plan's as if it did")
    return why


def run_cell(arch_id: str, shape_name: str, mesh, mesh_name: str) -> Dict:
    cfg = dataclasses.replace(configs.get_config(arch_id), unroll_scan=True)
    t0 = time.perf_counter()
    cell, meta = lower_cell(arch_id, shape_name, mesh, cfg=cfg)
    t_lower = time.perf_counter() - t0
    cost = count_step(cell.step, mesh)
    devices = mesh.size()
    shape = configs.SHAPES[shape_name]
    plan = DataParallelPlan(cfg, M.abstract_params(cfg), mesh,
                            AdamW() if shape.kind == "train" else None)
    coll = plan.collective_bytes(shape.kind, shape.global_batch, shape.seq_len)
    why_coll = collective_why(plan, mesh)
    return {
        **meta,
        "mesh": mesh_name,
        "devices": devices,
        "time_lower_s": round(t_lower, 2),
        "time_compile_s": None,
        "time_count_s": round(cost["seconds"], 2),
        "flops_raw": cost["flops"] / devices,
        "bytes_raw": cost["bytes"] / devices,
        "collective_bytes_raw": coll,
        "memory": {
            "argument_size_bytes": per_device_bytes(cell.arguments, mesh),
            "output_size_bytes": per_device_bytes(cell.outputs, mesh),
            "temp_size_bytes": None,
            "generated_code_size_bytes": None,
        },
        "flops": cost["flops"] / devices,
        "flops_total": cost["flops"],
        "bytes_accessed": cost["bytes"] / devices,
        "bytes_accessed_total": cost["bytes"],
        "collective_bytes": coll,
        "cost_detail": {
            "n_periods": cfg.n_periods,
            "dispatched_ops": cost["ops"],
            "counter": "torch.utils.flop_counter.FlopCounterMode: matmul-class ops of the "
                       "whole step, every period (eager code runs each period, so no 1- and "
                       "2-period difference is taken); elementwise work is not counted",
            "per_device": "flops and bytes_accessed are the totals over the mesh's devices, "
                          "the plan's even share; eager PyTorch has no partitioner to report "
                          "per-device counts",
            "unroll_scan": "set, as the reference's cost compiles set it: in eager code it "
                           "changes only the sLSTM, to its FLOP-equivalent parallel form",
        },
        "why": {
            "time_compile_s": _COMPILER_ONLY,
            "temp_size_bytes": _COMPILER_ONLY,
            "generated_code_size_bytes": _COMPILER_ONLY,
            "collective_bytes": why_coll,
            "collective_bytes_raw": why_coll,
        },
    }


def run_oavi_cell(mesh, mesh_name: str, *, m_global: int = 4_194_304,
                  n_features: int = 57, Lcap: int = 256, Kcap: int = 64,
                  dtype: str = "float32") -> Dict:
    """The paper's technique on the mesh: one OAVI degree step (the border
    and both Gram blocks, then the degree's candidate loop through the
    Theorem 4.9 inverse) at the rows one device holds, the sample axis
    sharded over every axis of the mesh.  Its collectives are the port's
    plan (``core/distributed.py``): one ``all_reduce`` of (QL, C) a degree,
    (L K + K K) floats, independent of m (Theorem 4.3's weak scaling)."""
    from ..kernels import ops

    devices = mesh.size()
    m_local = math.ceil(m_global / devices)
    dt = getattr(torch, dtype)

    def meta(*shape, dtype=dt):
        return torch.empty(shape, dtype=dtype, device="meta")

    A, X = meta(m_local, Lcap), meta(m_local, n_features)
    parents, vars_ = meta(Kcap, dtype=torch.int64), meta(Kcap, dtype=torch.int64)
    N = meta(Lcap, Lcap)

    def step():
        QL, C = ops.gram_accumulate(A, X, parents, vars_)
        # the shards' (QL, C) are summed by the one all_reduce (counted below)
        return ops.ihb_degree(QL.T / m_global, C / m_global, N, ell0=1, psi=0.005, K=Kcap)

    t0 = time.perf_counter()
    cost = count_step(step, mesh)
    t_lower = time.perf_counter() - t0
    width = torch.finfo(dt).bits // 8
    all_reduce = (Lcap * Kcap + Kcap * Kcap) * width
    kinds = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")
    coll = {k: 0 for k in kinds}
    coll["all-reduce"] = all_reduce
    coll["total"] = all_reduce
    return {
        "arch": "oavi-gram-step",
        "shape": f"m{m_global // 1_000_000}M_n{n_features}_L{Lcap}_K{Kcap}",
        "kind": "oavi",
        "mesh": mesh_name,
        "devices": devices,
        "time_lower_s": round(t_lower, 2),
        "time_compile_s": None,
        "flops": cost["flops"],
        "bytes_accessed": cost["bytes"],
        "collective_bytes": coll,
        "memory": {
            "argument_size_bytes": (A.numel() + X.numel() + N.numel()) * width
            + 2 * Kcap * 8,
            "output_size_bytes": (Lcap * Kcap + Kcap * Kcap + Lcap * Lcap) * width,
            "temp_size_bytes": None,
        },
        "cost_detail": {
            "m_local": m_local,
            "dispatched_ops": cost["ops"],
            "counter": "FlopCounterMode over one device's rows (the plain versions of "
                       "gram_update_acc and ihb_degree on meta; the degree loop's "
                       "matrix-vector work is not a matmul-class op and is not counted)",
            "collectives": "core/distributed.py: one all_reduce of (QL, C) a degree",
        },
        "why": {"time_compile_s": _COMPILER_ONLY, "temp_size_bytes": _COMPILER_ONLY},
    }


def main(argv=None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--oavi", action="store_true",
                    help="count the paper's OAVI degree step on the mesh")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", type=str, default="results")
    args = ap.parse_args(argv)
    if not (args.all or args.oavi or (args.arch and args.shape)):
        ap.error("give --arch and --shape, --all, or --oavi")

    mesh = mesh_mod.abstract_production_mesh(multi_pod=args.multi_pod)
    mesh_name = "pod2x16x16" if args.multi_pod else "pod16x16"
    os.makedirs(args.out, exist_ok=True)
    out_path = os.path.join(args.out, f"dryrun_torch_{mesh_name}.json")
    results: List[Dict] = []
    if os.path.exists(out_path):
        with open(out_path) as f:
            results = json.load(f)

    def record(rec):
        results[:] = [r for r in results if (r["arch"], r["shape"]) != (rec["arch"], rec["shape"])]
        results.append(rec)
        with open(out_path, "w") as f:
            json.dump(results, f, indent=1)

    if args.oavi:
        rec = run_oavi_cell(mesh, mesh_name)
        record(rec)
        print(f"  oavi ok: flops={rec['flops']:.3e} bytes={rec['bytes_accessed']:.3e} "
              f"coll={rec['collective_bytes']['total']:.3e}", flush=True)
    if args.all:
        cells = [(a, s) for a, s, ok, _ in configs.all_cells() if ok]
    elif args.arch:
        cells = [(args.arch, args.shape)]
    else:
        cells = []
    for arch_id, shape_name in cells:
        print(f"[dryrun_torch:{mesh_name}] {arch_id} x {shape_name} ...", flush=True)
        rec = run_cell(arch_id, shape_name, mesh, mesh_name)
        record(rec)
        print(f"  ok: flops={rec['flops']:.3e} bytes={rec['bytes_accessed']:.3e} "
              f"args/device={rec['memory']['argument_size_bytes']:.3e} "
              f"build={rec['time_lower_s']}s count={rec['time_count_s']}s", flush=True)
    print(f"wrote {out_path} ({len(results)} cells)")
    return results


if __name__ == "__main__":
    main()
