"""The port's dry-run layer against the JAX package's, on the CPU: the HLO
parsers, the cell grid and the tuned profile, the abstract (meta) build of
inputs, caches and parameters, and the sharding rules.

Everything here is exact: shapes, types, specs and byte counts are
integers and names, so each is held equal to the reference's.  The
sharding rules are held at the production mesh shapes (16 x 16 and
2 x 16 x 16) through a mesh of axis names and sizes only, which both
packages' rules accept (no devices), and with no mesh.  A port spec is a
tuple; the reference's ``PartitionSpec`` is compared as ``tuple(spec)``,
without the leading period axis (``None``) of a stacked block leaf.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import hlo_analysis as jhlo
from repro.models import model as JM
from repro.optim import AdamW as JAdamW
from repro_torch import configs
from repro_torch.launch import dryrun, hlo_analysis, mesh as mesh_mod
from repro_torch.models import model as M
from repro_torch.optim import AdamW
from repro_torch.runtime.data_parallel import DataParallelPlan

ALL_ARCHS = sorted(configs.ARCHS)
MESHES = {
    "none": None,
    "pod16x16": SimpleNamespace(axis_names=("data", "model"), shape={"data": 16, "model": 16}),
    "pod2x16x16": SimpleNamespace(axis_names=("pod", "data", "model"),
                                  shape={"pod": 2, "data": 16, "model": 16}),
}

HLO_TEXTS = {
    # tests/test_dryrun_unit.py's sample
    "unit-sample": """
HloModule test
  %x = bf16[256,4096]{1,0} parameter(0)
  %ar = bf16[256,4096]{1,0} all-reduce(bf16[256,4096]{1,0} %x), replica_groups={}
  %ag = f32[512,128]{1,0} all-gather(f32[256,128]{1,0} %y), dimensions={0}
  %rs = f32[128]{0} reduce-scatter(f32[512]{0} %z), dimensions={0}
  %a2a = (s32[64]{0}, s32[64]{0}) all-to-all(s32[64]{0} %a, s32[64]{0} %b)
  %cp-start = bf16[32,32]{1,0} collective-permute-start(bf16[32,32]{1,0} %c)
  %cp-done = bf16[32,32]{1,0} collective-permute-done(bf16[32,32]{1,0} %cp-start)
  %not-a-collective = f32[1024]{0} add(f32[1024]{0} %p, f32[1024]{0} %q)
""",
    "async-all-reduce": """
  %ars = (f32[16,16]{1,0}, f32[16,16]{1,0}) all-reduce-start(f32[16,16]{1,0} %a)
  %ard = f32[16,16]{1,0} all-reduce-done((f32[16,16]{1,0}, f32[16,16]{1,0}) %ars)
  %ag = pred[8]{0} all-gather(pred[1]{0} %m), dimensions={0}
""",
    "fp8-and-scalars": """
  %a = f8e4m3[1024,64]{1,0} all-to-all(f8e4m3[1024,64]{1,0} %x)
  %b = u8[] collective-permute(u8[] %y), source_target_pairs={{0,1}}
  %c = s64[3,5]{1,0} reduce-scatter(s64[48,5]{1,0} %z), dimensions={0}
  %d = c64[4]{0} all-reduce(c64[4]{0} %w)
""",
    "none": "HloModule empty\n  %x = f32[4]{0} parameter(0)\n",
}


@pytest.mark.parametrize("name", sorted(HLO_TEXTS))
def test_hlo_analysis_matches_reference(name):
    text = HLO_TEXTS[name]
    assert hlo_analysis.collective_bytes(text) == jhlo.collective_bytes(text)
    for line in text.splitlines():
        assert hlo_analysis._shape_bytes(line) == jhlo._shape_bytes(line)


def test_cell_grid_matches_reference():
    cells = configs.all_cells()
    assert cells == jconfigs.all_cells()
    assert len(cells) == 40 and sum(ok for _, _, ok, _ in cells) == 31


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_get_optimized_matches_reference(arch):
    got, want = configs.get_optimized(arch), jconfigs.get_optimized(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.attn_impl == "chunked" and got.attn_chunk == 1024
    assert got.moe is None or got.moe.dispatch == "rowwise"


def _same_leaf(t: torch.Tensor, want_shape, want_dtype) -> None:
    assert t.device.type == "meta"
    assert tuple(t.shape) == tuple(want_shape)
    assert str(t.dtype).removeprefix("torch.") == np.dtype(want_dtype).name


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_input_specs_match_reference(arch):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    for name, shape in configs.SHAPES.items():
        got = configs.input_specs(cfg, shape)
        want = jconfigs.input_specs(jcfg, jconfigs.SHAPES[name])
        assert set(got) == set(want)
        for k in got:
            _same_leaf(got[k], want[k].shape, want[k].dtype)


@functools.lru_cache(maxsize=None)
def _ref_abstract_params(arch):
    return JM.abstract_params(jconfigs.get_config(arch))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return dict(M.abstract_params(configs.get_config(arch)).named_parameters())


def _ref_leaves(tree, cfg):
    """The reference's leaves keyed by the port's names, a block leaf's
    period axis taken off: ``{name: (leaf, stacked)}``."""
    out = {k: (tree[k], False) for k in ("embed", "embed_proj", "head", "final_norm")
           if k in tree}
    P = len(cfg.period)
    for key, block in tree["blocks"].items():
        j = int(key[:2])
        for leaf, v in block.items():
            for i in range(cfg.n_periods):
                out[f"blocks.{i * P + j}.{leaf}"] = (v, True)
    return out


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_abstract_params_match_reference(arch):
    """Every leaf of the full config on meta: the reference's shape (without
    the period axis) and type; Kimi-K2's 1.04 T and Jamba's 398.6 B
    parameters allocate nothing."""
    cfg = configs.get_config(arch)
    got = _port_params(arch)
    want = _ref_leaves(_ref_abstract_params(arch), cfg)
    assert set(got) == set(want)
    for name, t in got.items():
        leaf, stacked = want[name]
        _same_leaf(t, leaf.shape[1:] if stacked else leaf.shape, leaf.dtype)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_abstract_cache_matches_reference(arch):
    """The serving cache at decode_32k's batch and depth (one entry a
    sub-block; None where the reference's is empty)."""
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    B, S = 128, 32768
    got = M.abstract_cache(cfg, B, S)
    want = JM.abstract_cache(jcfg, B, S)
    P = len(cfg.period)
    assert len(got) == cfg.n_periods * P
    for idx, c in enumerate(got):
        j = idx % P
        ref = want[f"{j:02d}_{cfg.period[j]}"]
        if not ref:
            assert c is None
            continue
        assert type(c).__name__ == type(ref).__name__ and c._fields == ref._fields
        for t, r in zip(c, ref):
            _same_leaf(t, r.shape[1:], r.dtype)


def _ref_spec(spec, stacked):
    spec = tuple(spec)
    return spec[1:] if stacked else spec


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_specs_match_reference(arch, mesh):
    cfg = configs.get_config(arch)
    m = MESHES[mesh]
    got = M.param_specs(cfg, _port_params(arch), m)
    jtree = _ref_abstract_params(arch)
    want = _ref_leaves(JM.param_specs(jconfigs.get_config(arch), jtree, m), cfg)
    assert set(got) == set(want)
    for name, spec in got.items():
        assert spec == _ref_spec(*want[name]), name


@pytest.mark.parametrize("mesh", ["pod16x16", "pod2x16x16"])
def test_batch_and_cache_specs_match_reference(mesh):
    m = MESHES[mesh]
    for arch, shape_name, ok, _ in configs.all_cells():
        if not ok:
            continue
        cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
        shape = configs.SHAPES[shape_name]
        got = M.batch_specs(cfg, m, shape.kind, shape.global_batch)
        want = JM.batch_specs(jcfg, m, shape.kind, shape.global_batch)
        assert got == {k: tuple(v) for k, v in want.items()}, (arch, shape_name)
        if shape.kind != "decode":
            continue
        cache = M.abstract_cache(cfg, shape.global_batch, shape.seq_len)
        jcache = JM.abstract_cache(jcfg, shape.global_batch, shape.seq_len)
        specs = M.cache_specs(cfg, cache, m)
        jspecs = JM.cache_specs(jcfg, jcache, m)
        P = len(cfg.period)
        for idx, s in enumerate(specs):
            ref = jspecs[f"{idx % P:02d}_{cfg.period[idx % P]}"]
            if s is None:
                assert not ref
                continue
            assert tuple(s) == tuple(_ref_spec(r, True) for r in ref), (arch, idx)
    assert M._batch_spec_entry(m, 1) is None  # long_500k's one request


@pytest.mark.parametrize("quantize", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_state_specs_match_reference(mesh, quantize):
    arch = "deepseek-v2-lite-16b"
    cfg = configs.get_config(arch)
    m = MESHES[mesh]
    pspecs = M.param_specs(cfg, _port_params(arch), m)
    got = AdamW(quantize_states=quantize).state_specs(pspecs)
    jtree = _ref_abstract_params(arch)
    jspecs = JM.param_specs(jconfigs.get_config(arch), jtree, m)
    want = JAdamW(quantize_states=quantize).state_specs(jspecs)
    assert got.step == tuple(want.step) == ()
    for port_tree, ref_tree in ((got.mu, want.mu), (got.nu, want.nu)):
        ref = _ref_leaves(ref_tree, cfg)
        assert set(port_tree) == set(ref)
        for name, spec in port_tree.items():
            leaf, stacked = ref[name]
            if quantize:
                assert spec == tuple(tuple(p) for p in leaf) == ((), ())
            else:
                assert spec == _ref_spec(leaf, stacked), name


def test_meta_device_and_kernel_path():
    """``"meta"`` is a device of the port's rule; a meta tensor takes the
    plain version (nothing is computed), and ``use_kernel=True`` raises."""
    from repro_torch import _device
    from repro_torch.kernels import ops

    assert _device.resolve("meta").type == "meta"
    q = torch.empty((1, 2, 8, 16), device="meta")
    assert ops.multihead_attention(q, q, q).device.type == "meta"
    with pytest.raises(ValueError, match="CUDA"):
        ops.multihead_attention(q, q, q, use_kernel=True)


def test_dryrun_cli_on_meta(tmp_path):
    """``python -m repro_torch.launch.dryrun`` on two full-size cells and the
    OAVI degree step, in a fresh process: records with the reference's keys,
    counts > 0, no CUDA initialized, no byte allocated on any device."""
    code = f"""
import json, sys, torch
from repro_torch.launch import dryrun
recs = dryrun.main(["--arch", "qwen2-1.5b", "--shape", "train_4k", "--oavi",
                    "--out", {str(tmp_path)!r}])
recs = dryrun.main(["--arch", "deepseek-v2-lite-16b", "--shape", "decode_32k",
                    "--out", {str(tmp_path)!r}])
print(json.dumps(dict(n=len(recs), cuda=torch.cuda.is_initialized())))
"""
    env = dict(os.environ, PYTHONPATH=os.path.abspath("src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary == {"n": 3, "cuda": False}
    recs = json.load(open(tmp_path / "dryrun_torch_pod16x16.json"))
    by = {(r["arch"], r["shape"]): r for r in recs}
    ref_keys = {"arch", "shape", "kind", "mesh", "devices", "time_lower_s", "time_compile_s",
                "flops_raw", "bytes_raw", "collective_bytes_raw", "memory", "flops",
                "bytes_accessed", "collective_bytes", "cost_detail"}
    mesh = mesh_mod.abstract_production_mesh()
    for key in (("qwen2-1.5b", "train_4k"), ("deepseek-v2-lite-16b", "decode_32k")):
        r = by[key]
        assert ref_keys <= set(r) and r["devices"] == 256
        assert r["flops"] > 0 and r["bytes_accessed"] > 0
        assert r["flops_total"] == r["flops"] * 256
        # the LM cells' collectives are the plan's, over the data axis and
        # the model axis (the Megatron plan of runtime/tensor_parallel.py)
        cfg, shape = configs.get_config(key[0]), configs.SHAPES[key[1]]
        plan = DataParallelPlan(cfg, M.abstract_params(cfg), mesh,
                                AdamW() if shape.kind == "train" else None)
        want = plan.collective_bytes(shape.kind, shape.global_batch, shape.seq_len)
        assert r["collective_bytes"] == r["collective_bytes_raw"] == want
        assert "tensor_parallel.py" in r["why"]["collective_bytes"]
        assert r["memory"]["temp_size_bytes"] is None and r["time_compile_s"] is None
    train = by[("qwen2-1.5b", "train_4k")]["collective_bytes"]
    # counted by hand: every matrix of Qwen2-1.5B is cut 16 ways over data
    # and 16 over model, so a device gathers each one's model block (1/16 of
    # it; a layer's inside its period, and again in its remat recompute:
    # twice, the embedding once) and receives 1/256 of its gradient; the
    # vectors (norms, biases) are all_reduced whole, or as their 16-way
    # model blocks (the biases)
    leaves = dict(M.abstract_params(configs.get_config("qwen2-1.5b")).named_parameters())
    mats = sum(p.numel() * 2 for p in leaves.values() if p.dim() == 2)
    gathered = 2 * mats - leaves["embed"].numel() * 2
    vecs = sum(p.numel() * 2 // (16 if k.split(".")[-1] in ("bq", "bk", "bv") else 1)
               for k, p in leaves.items() if p.dim() == 1)
    # Over the model axis: Qwen2-1.5B's 2 KV heads do not split 16 ways, so
    # each layer's wk, wv, bk, bv are gathered whole (inside the period:
    # twice) and their gradients reduce-scattered back to 1/16; a device's
    # 16 rows of 4,096 tokens
    # (act: its (16, 4096, 1536) bf16 activations) are all_reduced by the
    # embedding and each of the 56 sub-blocks, again by the remat recompute
    # but for each layer's last (the MLP's), by the backward of the 56
    # sub-blocks' inputs and the unembedding's; the CE reduces 3 fp32 a token
    kv = 28 * (2 * 1536 * 256 + 2 * 256) * 2
    T = 16 * 4096
    act = T * 1536 * 2
    model_ar = act * (1 + 56 + 28) + act * (56 + 1) + 3 * T * 4
    assert train == {"all-gather": gathered // 16 + 2 * kv,
                     "reduce-scatter": mats // 256 + kv // 16,
                     "all-reduce": vecs + 8 + model_ar,
                     "total": gathered // 16 + mats // 256 + vecs + 8 + 2 * kv + kv // 16
                     + model_ar}
    decode = by[("deepseek-v2-lite-16b", "decode_32k")]["collective_bytes"]
    # 27 MoE blocks: the aux loss's two all_reduces (64 fp32 sums, 64 int64
    # counts) and, the global dispatch at capacity factor 1.25 planning one
    # row over the 16 ranks, the all_gather of every rank's 64 counts; over
    # the model axis, a device's 8 new tokens' (8, 1, 2048) bf16 activations
    # all_reduced by the embedding and the 54 sub-blocks, and the gather of
    # their 102,400-id logits
    model_ar, logits = 8 * 2048 * 2 * 55, 8 * 102400 * 2
    assert decode == {"all-reduce": 27 * 64 * 12 + model_ar,
                      "all-gather": 27 * 16 * 64 * 8 + logits, "reduce-scatter": 0,
                      "total": 27 * 64 * (12 + 16 * 8) + model_ar + logits}
    # the full-size train cell's count is every product of the step
    assert by[("qwen2-1.5b", "train_4k")]["flops_total"] == dense_matmul_flops(
        configs.get_config("qwen2-1.5b"), configs.SHAPES["train_4k"])
    oavi = by[("oavi-gram-step", "m4M_n57_L256_K64")]
    assert oavi["flops"] > 0 and oavi["collective_bytes"]["all-reduce"] == (256 * 64 + 64 * 64) * 4


def test_mixers_and_frames_model_axis_collectives_by_hand():
    """The model axis's activation collectives (``tensor_parallel.
    collectives``, part of every LM cell's ``collective_bytes``) at train_4k
    on the production mesh (data 16, model 16), counted by hand where the
    config runs there; xLSTM-1.3B's 4 heads do not split 16 ways, and
    ``why`` names the heads."""
    from repro_torch.runtime import tensor_parallel as tp

    mesh = mesh_mod.abstract_production_mesh()
    shape = configs.SHAPES["train_4k"]
    rows = shape.global_batch // 16
    T = rows * shape.seq_len
    # Jamba-1.5-Large: 9 periods of 16 sub-blocks (7 Mamba, 1 attention, 4
    # MLP, 4 MoE).  Each sub-block's g, again under remat but for each
    # period's last; the embedding's g (65,536 ids split 16 ways); each
    # Mamba layer's two-way sum of (dt_rank 512 | B 16 | C 16) bf16 a token,
    # forward twice (remat) and backward once; every f's backward, the MoE
    # gates' (top-2 fp32), the unembedding's and the CE's three fp32 sums
    jamba = configs.get_config("jamba-1.5-large-398b")
    act = T * 8192 * 2
    mamba = 63 * T * (512 + 2 * 16) * 2
    want = (act * (144 + 135) + 3 * mamba + act + act * 144 + 36 * T * 2 * 4 + act
            + 3 * T * 4)
    assert tp.collectives(jamba, "train", rows, shape.seq_len, 16) == {
        "all-reduce": want, "all-gather": 0}
    plan = DataParallelPlan(jamba, M.abstract_params(jamba), mesh, AdamW())
    assert plan.refusal is None and "not run" not in dryrun.collective_why(plan, mesh)
    # HuBERT-XLarge: 48 periods of (attn, mlp); frames in (no embedding
    # g), 504 classes do not split 16 ways (a whole head: no unembedding f,
    # no CE sums); embed_proj gathered whole for the step, its gradient whole
    hubert = configs.get_config("hubert-xlarge")
    act = T * 1280 * 2
    assert tp.collectives(hubert, "train", rows, shape.seq_len, 16) == {
        "all-reduce": act * (96 + 48) + act * 96, "all-gather": 0}
    plan = DataParallelPlan(hubert, M.abstract_params(hubert), mesh, AdamW())
    assert plan.leaves["head"].mdim is None and plan.leaves["embed_proj"].gathered
    assert plan.refusal is None
    # xLSTM-1.3B: 48 mLSTM and sLSTM layers of 4 heads
    xlstm = configs.get_config("xlstm-1.3b")
    plan = DataParallelPlan(xlstm, M.abstract_params(xlstm), mesh, AdamW())
    why = dryrun.collective_why(plan, mesh)
    assert "4 mLSTM heads do not split over a model axis of 16" in why and "14k" not in why
    assert "does not run" in why and "as if it did" in why


# ---------------------------------------------------------------------------
# The dry run's numbers against the JAX package's compiled cells
# ---------------------------------------------------------------------------

# cells small enough for the reference to lower and compile on 4 host devices
SMALL_SHAPES = {
    "train_small": configs.Shape("train_small", "train", 32, 4),
    "prefill_small": configs.Shape("prefill_small", "prefill", 64, 2),
    "decode_small": configs.Shape("decode_small", "decode", 64, 4),
}
SMALL_ARCHS = ("qwen3-8b", "deepseek-v2-lite-16b")

# The reference's ``lower_cell`` on a (data=2, model=2) mesh of 4 host
# devices, each reduced cell compiled under ``unroll_scan`` (its cost mode:
# every period in the module, so ``cost_analysis`` counts each).  The device
# count is fixed by the first ``jax.devices()``, before the reference's
# dryrun module (which asks for 512) is imported.
REF_CELLS = textwrap.dedent("""
    import dataclasses, json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import numpy as np
    assert len(jax.devices()) == 4
    from jax.sharding import Mesh
    from repro import configs
    from repro.configs.shapes import Shape
    from repro.launch import dryrun
    shapes = json.loads(sys.argv[1])
    for name, (kind, S, B) in shapes.items():
        configs.SHAPES[name] = Shape(name, kind, S, B)
    mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
    out = {}
    for arch in json.loads(sys.argv[2]):
        cfg = dataclasses.replace(configs.get_reduced(arch), unroll_scan=True)
        for name in shapes:
            lowered, _ = dryrun.lower_cell(arch, name, mesh, cfg=cfg)
            compiled = lowered.compile()
            mem = compiled.memory_analysis()
            out[arch + "/" + name] = dict(
                arguments=mem.argument_size_in_bytes, outputs=mem.output_size_in_bytes,
                output_leaves=len(jax.tree.leaves(lowered.out_info)),
                flops=compiled.cost_analysis()["flops"])
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def ref_cells():
    shapes = {k: (s.kind, s.seq_len, s.global_batch) for k, s in SMALL_SHAPES.items()}
    env = dict(os.environ, PYTHONPATH=os.path.abspath("src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", REF_CELLS, json.dumps(shapes),
                          json.dumps(SMALL_ARCHS)], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def dense_matmul_flops(cfg, shape) -> int:
    """Every product of a dense attention + MLP cell, 2 m n k each, counted
    by hand: per token a period's q, k, v and o projections and the SwiGLU's
    three; per head of a sequence the scores and the weighted sum over the
    keys it attends (all of them: the plain attention masks, it does not
    skip); the unembedding of every position (train) or of the last (prefill,
    decode).  Train is the forward, the backward's two products for each
    (3 F), and remat's recompute of each period, which stops before the
    period's last product (the MLP's down projection, whose output the
    backward does not need)."""
    d, H, Hkv, dh, ff = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_ff
    B, S = shape.global_batch, shape.seq_len
    T = B if shape.kind == "decode" else B * S
    Sq, Sk = (1, S) if shape.kind == "decode" else (S, S)
    proj = 2 * T * (d * H * dh + 2 * d * Hkv * dh + H * dh * d + 3 * d * ff)
    period = proj + 4 * B * H * Sq * Sk * dh
    head = 2 * (T if shape.kind == "train" else B) * d * cfg.vocab_size
    forward = cfg.n_periods * period + head
    if shape.kind != "train":
        return forward
    assert cfg.remat and cfg.remat_policy == "full"
    return 3 * forward + cfg.n_periods * (period - 2 * T * ff * d)


@pytest.mark.parametrize("shape_name", sorted(SMALL_SHAPES))
@pytest.mark.parametrize("arch", SMALL_ARCHS)
def test_dryrun_bytes_and_flops_match_reference(arch, shape_name, ref_cells, monkeypatch):
    """A reduced cell on a 2 x 2 abstract mesh against the reference's cell
    compiled on 4 host devices.  Bytes exactly: the arguments are the
    compiled module's ``argument_size_in_bytes``; its
    ``output_size_in_bytes`` also counts the result tuple's table, one
    8-byte pointer a leaf.  FLOPs: the dense cell's count is every product
    counted by hand (exact); both cells' counts lie within [0.5, 1] of
    XLA's over the 4 devices, which counts every product (those of
    replicated values once a device) and elementwise work besides (norms,
    softmax, RoPE, routing: up to 35% at these widths, d = 64), so a count
    that lost the backward (a third) or the products of a layer falls out."""
    for name, shape in SMALL_SHAPES.items():
        monkeypatch.setitem(configs.SHAPES, name, shape)
    ref = ref_cells[f"{arch}/{shape_name}"]
    mesh = mesh_mod.AbstractMesh((2, 2), ("data", "model"))
    cfg = dataclasses.replace(configs.get_reduced(arch), unroll_scan=True)
    cell, _ = dryrun.lower_cell(arch, shape_name, mesh, cfg=cfg)
    assert dryrun.per_device_bytes(cell.arguments, mesh) == ref["arguments"]
    assert dryrun.per_device_bytes(cell.outputs, mesh) + 8 * ref["output_leaves"] \
        == ref["outputs"]
    flops = dryrun.count_step(cell.step, mesh)["flops"]
    if arch == "qwen3-8b":
        assert flops == dense_matmul_flops(cfg, SMALL_SHAPES[shape_name])
    assert 0.5 <= flops / (mesh.size() * ref["flops"]) <= 1.0
