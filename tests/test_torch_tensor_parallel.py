"""Tensor parallelism: LM training and serving over a ``model`` axis larger
than 1 (``runtime/tensor_parallel.py``; the model axis of
``runtime/data_parallel.py``'s plan; attention, MLA, the MLP, the MoE's
experts and the vocabulary cut over it) on the CPU.

The ranks are gloo processes spawned once for the module
(``_torch_tensor_parallel_ranks.py``): a world of 2 runs a (data 1, model 2)
mesh (and a (data 2, model 1) mesh for a checkpoint's resume), a world of 4
a (data 2, model 2) and a (data 1, model 4) mesh.  One subprocess runs the
JAX package's ``train`` on (1, 2) and (2, 2) meshes of 4 host devices and
its ``serve`` on (1, 2), and compiles its step for the GSPMD collectives.
Every case starts from the JAX package's initial parameters, converted:
reduced Qwen2-1.5B (tied embedding, 2 KV heads), Qwen3-8B (untied,
``qk_norm``, one KV head: gathered over the model axis), DeepSeek-V2-Lite
(MLA + MoE) and Kimi-K2 (GQA + MoE), all fp32.

Tolerances (fp32): the ranks' losses and gathered states equal each other
bit for bit.  Against the port's one-device run the sums run in another
order (a block's partial products summed over the axis), so losses agree to
``PORT_TOL`` (rtol 1e-5), gradients to ``GRAD_TOL`` and states by the rule
of ``tests/test_torch_train_mesh.py``.  Against the JAX package's ``train``
on the same mesh the losses agree to ``PORT_TOL`` too.
"""

import dataclasses
import functools
import json
import os
import shutil
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

import _torch_tensor_parallel_ranks as TPR
import _torch_train_mesh_ranks as R
from repro import configs as jconfigs
from repro.models import model as JM
from repro_torch import configs
from repro_torch.convert import lm_params_from_reference
from repro_torch.data import lm as lm_data
from repro_torch.launch import hlo_analysis
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import train as train_mod
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import hints
from repro_torch.models import model as M
from repro_torch.models.model import Transformer, make_train_step
from repro_torch.optim import AdamW
from repro_torch.runtime import tensor_parallel as tp
from repro_torch.runtime.data_parallel import DataParallelPlan

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
RANK_TIMEOUT_S = 240
PORT_TOL = dict(rtol=1e-5, atol=1e-6)
# a gradient entry is a sum of the model ranks' partial sums: fp32 rounding
# of the largest partial, relative to the leaf's largest entry
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)

DENSE, QWEN3, DEEPSEEK, KIMI = "qwen2-1.5b", "qwen3-8b", "deepseek-v2-lite-16b", "kimi-k2-1t-a32b"
ARCHS = (DENSE, QWEN3, DEEPSEEK, KIMI)
MOE = (DEEPSEEK, KIMI)
# each run's config: an arch, and beside the four: the chunked CE with chunks
# that straddle a rank's vocabulary block, get_optimized's rowwise MoE
# dispatch, and two configs from the port's own seeded init (no reference
# parameters): Phi-4-mini (tied) and Qwen2-VL's text backbone (M-RoPE)
VARIANTS = {**{a: dict(arch=a) for a in ARCHS},
            "qwen2-chunked": dict(arch=DENSE, ce_chunk=48),
            "deepseek-rowwise": dict(arch=DEEPSEEK, dispatch="rowwise"),
            "phi4-mini-3.8b": dict(arch="phi4-mini-3.8b", random=True),
            "qwen2-vl-2b": dict(arch="qwen2-vl-2b", random=True)}
TRAIN = ([(a, m) for a in ARCHS for m in ("1x2", "2x2")]
         + [(DENSE, "1x4"), ("qwen2-chunked", "1x2"), ("deepseek-rowwise", "2x2"),
            ("phi4-mini-3.8b", "1x2"), ("qwen2-vl-2b", "1x2")])
SERVE = ([(a, "1x2") for a in ARCHS] + [(QWEN3, "2x2"), (DENSE, "1x4")]
         + [(v, "1x2") for v in ("phi4-mini-3.8b", "qwen2-vl-2b")])
CONTROLS = {"no_sum": DENSE, "times_k": DENSE, "aux_k": DEEPSEEK, "aux_grad": DEEPSEEK,
            "no_sum_moe": DEEPSEEK}
# the per-period step against the whole-gather step on (data 2, model 2):
# the dense config under each remat, DeepSeek's MLA + MoE (capacity factor
# 1.25: the global dispatch's count gather inside every period) under full
PER_PERIOD = [("dense", "full"), ("dense", "dots"), ("dense", "off"), ("deepseek", "full")]
PP_CONFIGS = {"dense": dict(arch=DENSE), "deepseek": dict(arch=DEEPSEEK, capacity=1.25)}


def _cases(kind, runs, world):
    return [dict(name=f"{kind}/{v}/{m}", kind=kind, mesh=[int(x) for x in m.split("x")],
                 **VARIANTS[v]) for v, m in runs if (m == "1x2") == (world == "2")]


CASES = {
    "2": dict(cases=[
        dict(name="fg", kind="fg", mesh=[1, 2]),
        *_cases("train", TRAIN, "2"),
        *_cases("serve", SERVE, "2"),
        *[dict(name=f"control/{c}", kind="control", arch=a, mesh=[1, 2],
               control=c.replace("_moe", "")) for c, a in CONTROLS.items()],
        # save at (1, 2) every 2 steps, then resume its step 4 at (2, 1)
        dict(name="ckpt/save12", kind="ckpt", arch=DENSE, mesh=[1, 2], dir="ck12", steps=4,
             whole=6),
        dict(name="ckpt/resume21", kind="ckpt", arch=DENSE, mesh=[2, 1], dir="ck12", steps=2),
    ]),
    "4": dict(cases=[
        *_cases("train", TRAIN, "4"),
        *_cases("serve", SERVE, "4"),
        # a one-device checkpoint at step 2 (the test's), resumed at (2, 2)
        dict(name="ckpt/resume22", kind="ckpt", arch=DENSE, mesh=[2, 2], dir="ck11", steps=2),
        *[dict(name=f"pp/{c}/{r}", kind="per_period", mesh=[2, 2], remat=r, **PP_CONFIGS[c])
          for c, r in PER_PERIOD],
    ]),
}
TWO_ROWS = AbstractMesh((2, 1), ("data", "model"))

# The JAX package's train of each arch on (data, model) meshes (1, 2) and
# (2, 2) of 4 host devices (the device count is fixed before JAX starts),
# its serve on (1, 2), and the compiled text of its train step of reduced
# Qwen2-1.5B on (1, 2) and (2, 1): one process, its programs compiled without most of
# XLA's optimisation passes (the same computations in half the compile
# time: the losses move by about 1e-7 relative, the tokens and the step's
# collectives not at all).
REF_MESH = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh
    from repro import configs
    from repro.launch import serve, train
    from repro.optim import AdamW
    jax.config.update("jax_disable_most_optimizations", True)
    assert len(jax.devices()) == 4
    archs = sys.argv[1].split(",")
    meshes = {s: Mesh(np.array(jax.devices()[:d * m]).reshape(d, m), ("data", "model"))
              for s, (d, m) in (("1x2", (1, 2)), ("2x2", (2, 2)))}
    opt = lambda: AdamW(peak_lr=1e-3, warmup_steps=1, total_steps=6)
    out = {"serve": {}}
    for shape, mesh in meshes.items():
        out[shape] = {}
        for arch in archs:
            rep = train.train(configs.get_reduced(arch), steps=3, global_batch=4, seq_len=16,
                              mesh=mesh, log_every=1000, opt=opt())
            out[shape][arch] = dict(losses=rep["losses"])
    for arch in archs:
        got = serve.serve(configs.get_reduced(arch), batch=4, prompt_len=16, gen_tokens=4,
                          seed=0, mesh=meshes["1x2"])
        out["serve"][arch] = dict(generated=np.asarray(got["generated"]).tolist())
    cfg = configs.get_reduced("qwen2-1.5b")
    meshes["2x1"] = Mesh(np.array(jax.devices()[:2]).reshape(2, 1), ("data", "model"))
    for shape, path in (("1x2", sys.argv[2]), ("2x1", sys.argv[2] + ".2x1")):
        mesh = meshes[shape]
        params, st, pshard, sshard = train.make_sharded_train_state(cfg, opt(), mesh, 0)
        step = train.make_step(cfg, opt(), mesh, pshard, sshard)
        with mesh:
            text = step.lower(params, st, {"tokens": jnp.zeros((4, 17), jnp.int32)}).compile()
        with open(path, "w") as f:
            f.write(text.as_text())
    print(json.dumps(out))
""")


def _ref_params(arch, jit=True):
    """The JAX package's initial parameters, seed 0, as the port's state
    dict: jitted as its ``train`` draws them, or eager as its ``serve``."""
    jcfg = jconfigs.get_reduced(arch)
    init = jax.jit(functools.partial(JM.init_params, cfg=jcfg)) if jit else functools.partial(
        JM.init_params, cfg=jcfg)
    jp = init(jax.random.PRNGKey(0))
    return lm_params_from_reference(jax.tree.map(np.asarray, jp), configs.get_reduced(arch))


def _env():
    return dict(os.environ, PYTHONPATH=SRC + os.pathsep + HERE + os.pathsep
                + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")


def _model(cfg, params):
    if params is None:  # the port's seeded init, as the ranks draw it
        return Transformer(cfg, device="cpu", seed=0)
    return Transformer.from_params(cfg, params, device="cpu")


def _batch(cfg, step):
    return {"tokens": torch.from_numpy(lm_data.global_batch_at(R.pipe(cfg), step)).long()}


def _one_device(cfg, params, rowwise):
    """The one-device run a variant is held to: ``R.run_steps``' losses and
    state, and step 0's loss and gradients; a rowwise dispatch under the
    two abstract rows the (2, 2) mesh's data axis makes (the rows of the
    reference's plan), through ``make_train_step``."""
    with hints.use_mesh(TWO_ROWS if rowwise else None):
        loss0, grads = M.loss_and_grads(_model(cfg, params), _batch(cfg, 0))
        if rowwise:
            model, opt = _model(cfg, params), R.optimizer()
            st, step, losses = opt.init(dict(model.named_parameters())), make_train_step(opt), []
            for i in range(R.STEPS):
                loss, st = step(model, st, _batch(cfg, i))
                losses.append(float(loss))
            state = {f"params/{k}": p.detach().numpy().copy()
                     for k, p in model.named_parameters()}
            for part in ("mu", "nu"):
                state.update({f"{part}/{k}": v.numpy().copy()
                              for k, v in getattr(st, part).items()})
            out = dict(losses=losses, state=state)
        else:
            out = R.run_steps(cfg, params, None, R.optimizer())
    out.update(loss0=float(loss0.detach()), grads={k: v.numpy() for k, v in grads.items()})
    return out


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """This module's one-device runs on one thread: the rank processes (and
    the other test workers) have the other cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawn the reference's job and both worlds once; with them, the
    one-device runs to compare."""
    work = str(tmp_path_factory.mktemp("tensor_parallel"))
    hlo = os.path.join(work, "ref_1x2.hlo")
    ref_job = subprocess.Popen([sys.executable, "-c", REF_MESH, ",".join(ARCHS), hlo],
                               env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                               text=True)
    every = [ref_job]
    try:
        params = {a: _ref_params(a) for a in ARCHS}
        served = {a: _ref_params(a, jit=False) for a in ARCHS}
        for a in ARCHS:
            np.savez(os.path.join(work, f"{a}.npz"),
                     **{k: v.numpy() for k, v in params[a].items()})
            np.savez(os.path.join(work, f"{a}_serve.npz"),
                     **{k: v.numpy() for k, v in served[a].items()})
        kw = dict(global_batch=R.BATCH, seq_len=R.SEQ, opt=R.optimizer(), params=params[DENSE],
                  device="cpu")
        # a one-device checkpoint at step 2, for the (2, 2) world to resume
        train_mod.train(configs.get_reduced(DENSE), steps=2, ckpt_dir=os.path.join(work, "ck11"),
                        ckpt_every=2, **kw)
        with open(os.path.join(work, "cases.json"), "w") as f:
            json.dump(CASES, f)
        for w in CASES:
            every += [subprocess.Popen([sys.executable,
                                        os.path.join(HERE, "_torch_tensor_parallel_ranks.py"),
                                        str(r), w, work], env=_env(), stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)
                      for r in range(int(w))]
        one = {}
        for v, spec in VARIANTS.items():
            cfg = TPR.case_config(spec)
            p = None if spec.get("random") else params[spec["arch"]]
            one[v] = _one_device(cfg, p, spec.get("dispatch") == "rowwise")
            if any(s == v for s, _ in SERVE):
                one[v]["serve"] = serve_mod.serve(cfg, params=served.get(v), device="cpu",
                                                  **R.SERVE)
        one["whole"] = train_mod.train(configs.get_reduced(DENSE), steps=6, **kw)["losses"]
        one["p4"] = R.run_steps(configs.get_reduced(DENSE), params[DENSE], None,
                                R.optimizer(), steps=4)["state"]
        outs, errs = {}, []
        for p in every:
            out, err = p.communicate(timeout=RANK_TIMEOUT_S)
            outs[p] = out
            if p.returncode:
                errs.append(err[-3000:])
        assert not errs, errs
        ref = json.loads(outs[ref_job].strip().splitlines()[-1])
    finally:
        for p in every:
            if p.poll() is None:
                p.kill()
                p.wait()
    got = {w: [torch.load(os.path.join(work, f"world{w}_rank{r}.pt"), weights_only=False)
               for r in range(int(w))] for w in CASES}
    with open(hlo) as f:
        ref["hlo"] = f.read()
    with open(hlo + ".2x1") as f:
        ref["hlo_2x1"] = f.read()
    return dict(work=work, params=params, got=got, one=one, ref=ref)


def _runs(ranks, mesh):
    return ranks["got"]["2" if mesh == "1x2" else "4"]


def _model_groups(mesh):
    """The ranks of each model group (a data index's), row-major."""
    d, m = (int(s) for s in mesh.split("x"))
    return [list(range(i * m, (i + 1) * m)) for i in range(d)]


# ---------------------------------------------------------------------------
# With processes
# ---------------------------------------------------------------------------


def test_f_and_g_match_their_definitions(ranks):
    """On two model ranks feeding x_r and backpropagating w_r: ``f`` returns
    x_r and the gradient w_0 + w_1; ``g`` returns x_0 + x_1 and the gradient
    w_r (a backward sum would give every rank w_0 + w_1)."""
    xs = [torch.arange(6.0).reshape(2, 3) + 10.0 * r for r in range(2)]
    ws = [torch.full((2, 3), 1.0 + r) for r in range(2)]
    for r, res in enumerate(ranks["got"]["2"]):
        res = res["fg"]
        torch.testing.assert_close(res["f"]["y"], xs[r], rtol=0, atol=0)
        torch.testing.assert_close(res["f"]["grad"], ws[0] + ws[1], rtol=0, atol=0)
        torch.testing.assert_close(res["g"]["y"], xs[0] + xs[1], rtol=0, atol=0)
        torch.testing.assert_close(res["g"]["grad"], ws[r], rtol=0, atol=0)
        # one all_reduce each of a (2, 3) fp32 tensor: f's backward, g's forward
        assert res["issued"] == {"all-reduce": 2 * 24, "all-gather": 0, "reduce-scatter": 0}


@pytest.mark.parametrize("arch, mesh", TRAIN, ids=[f"{a}-{m}" for a, m in TRAIN])
def test_losses_match_one_device_and_reference(ranks, arch, mesh):
    """Every rank's losses are equal bit for bit (a model group's ranks hold
    the same loss, the batch ranks average theirs); within PORT_TOL of the
    port's one-device run and of the JAX package's ``train`` on the same
    (data, model) host mesh (k = 4 has no reference mesh: 4 host devices
    hold only (1, 4), whose GSPMD cut of 2 KV heads is the 1 x 2 case's)."""
    runs = [r[f"train/{arch}/{mesh}"] for r in _runs(ranks, mesh)]
    for r in runs:
        assert r["losses"] == runs[0]["losses"]
    np.testing.assert_allclose(runs[0]["losses"], ranks["one"][arch]["losses"], **PORT_TOL)
    if mesh in ranks["ref"] and arch in ARCHS:
        np.testing.assert_allclose(runs[0]["losses"], ranks["ref"][mesh][arch]["losses"],
                                   **PORT_TOL)


@pytest.mark.parametrize("arch, mesh", TRAIN, ids=[f"{a}-{m}" for a, m in TRAIN])
def test_grads_and_params_match_one_device(ranks, arch, mesh):
    """Step 0's gradients, synchronised over both axes and gathered into the
    one-device layout (a packed SwiGLU matrix unpacked), leaf by leaf within
    GRAD_TOL of one device's; the gathered state after three steps equal on
    every rank bit for bit and within the Adam rule of one device's."""
    one = ranks["one"][arch]
    runs = [r[f"train/{arch}/{mesh}"] for r in _runs(ranks, mesh)]
    np.testing.assert_allclose(runs[0]["loss0"], one["loss0"], **PORT_TOL)
    for k, g1 in one["grads"].items():
        scale = float(np.abs(g1).max())
        np.testing.assert_allclose(runs[0]["grads"][k], g1, rtol=GRAD_TOL["rtol"],
                                   atol=GRAD_TOL["atol"] * max(scale, 1.0), err_msg=k)
    for r in runs[1:]:
        for k, v in runs[0]["state"].items():
            assert v.tobytes() == r["state"][k].tobytes(), k
    _state_close(runs[0]["state"], one["state"], R.optimizer().peak_lr)


def _grad_close(got, want) -> bool:
    """GRAD_TOL, its atol relative to the leaf's largest entry."""
    return np.allclose(got, want, rtol=GRAD_TOL["rtol"],
                       atol=GRAD_TOL["atol"] * max(float(np.abs(want).max()), 1.0))


def _state_close(got, want, lr):
    """``tests/test_torch_train_mesh.py``'s rule: every parameter entry
    within 3 lr, all but 0.1% of the entries within rtol 1e-4 / atol 1e-5."""
    off = total = 0
    for k, w in want.items():
        g = got[k]
        if k.startswith("params/"):
            assert np.abs(g - w).max() <= 3 * lr, k
        off += int(np.sum(np.abs(g - w) > 1e-5 + 1e-4 * np.abs(w)))
        total += w.size
    assert off <= 1e-3 * total, (off, total)


@pytest.mark.parametrize("arch, mesh", TRAIN, ids=[f"{a}-{m}" for a, m in TRAIN])
def test_collectives_issued_equal_the_plan(ranks, arch, mesh):
    """Every collective the ranks issued, counted by the transport, equals
    ``plan.collective_bytes()`` by kind (per step, times the steps), the
    model axis's included; the bytes a rank holds between steps equal
    ``at_rest_bytes``; a MoE's route ids are the same on every rank of a
    model group (the plan is computed on each)."""
    runs = [r[f"train/{arch}/{mesh}"] for r in _runs(ranks, mesh)]
    for r in runs:
        assert r["issued"] == r["want"]
        assert r["want"]["all-reduce"] > 0
        assert r["held"] == r["at_rest"]
    if VARIANTS[arch]["arch"] in MOE:
        for group in _model_groups(mesh):
            ids = [runs[i]["routes"] for i in group]
            assert len(ids[0]) > 0
            for other in ids[1:]:
                assert all(torch.equal(a, b) for a, b in zip(ids[0], other))


@pytest.mark.parametrize("arch, mesh", SERVE, ids=[f"{a}-{m}" for a, m in SERVE])
def test_serve_matches_one_device_and_reference(ranks, arch, mesh):
    """``serve(mesh=)``: every rank returns the whole batch's tokens, those
    of a one-device ``serve`` and, for the reference's four archs, of the
    JAX package's on a (1, 2) host mesh; its prefill logits (gathered over
    the model axis) are its rows' of one device's; a rank holds about 1/k
    of the weights."""
    one = ranks["one"][arch]["serve"]
    runs = [r[f"serve/{arch}/{mesh}"] for r in _runs(ranks, mesh)]
    d, m = (int(s) for s in mesh.split("x"))
    n = R.BATCH // d
    for i, r in enumerate(runs):
        np.testing.assert_array_equal(r["generated"], one["generated"])
        if arch in ARCHS:
            np.testing.assert_array_equal(r["generated"],
                                          ranks["ref"]["serve"][arch]["generated"])
        lo = (i // m) * n
        np.testing.assert_allclose(r["logits"].numpy(), one["prefill_logits"][lo:lo + n].numpy(),
                                   **PORT_TOL)
        assert one["at_rest_bytes"] / m <= r["at_rest"] < one["at_rest_bytes"] / m * 1.1


@pytest.mark.parametrize("control", list(CONTROLS))
def test_controls_fail_the_gates(ranks, control):
    """Each fault fails a gate the sound runs pass (their loss gate, step
    0's gradients within GRAD_TOL, or the state's 3 lr rule): the partial
    gradients' sum over the model axis left out (in the dense model, and in
    the MoE's gates and router), a sum added where every rank already holds
    the whole gradient (x k), the aux loss counted k times, and the aux
    loss counted once but its gradient k times (which moves the router's
    gradient only)."""
    arch = CONTROLS[control]
    res = ranks["got"]["2"][0][f"control/{control}"]
    one = ranks["one"][arch]
    loss_bad = not np.allclose(res["losses"], one["losses"], **PORT_TOL)
    grads_bad = [k for k, g1 in one["grads"].items() if not _grad_close(res["grads"][k], g1)]
    params_bad = any(np.abs(res["state"][k] - w).max() > 3 * R.optimizer().peak_lr
                     for k, w in one["state"].items() if k.startswith("params/"))
    assert loss_bad or grads_bad or params_bad
    if control == "aux_grad":  # the loss's value is the sound run's at step 0
        np.testing.assert_allclose(res["losses"][0], one["losses"][0], **PORT_TOL)
        assert any(k.endswith(".router") for k in grads_bad), grads_bad


@pytest.mark.parametrize("config, remat", PER_PERIOD, ids=[f"{c}-{r}" for c, r in PER_PERIOD])
def test_per_period_step_equals_whole_gather_step(ranks, config, remat):
    """On (data 2, model 2) each period's leaves are gathered inside it by
    the same ``compute`` (a leaf cut over both axes keeps its model block
    and packed layout; the gathered KV leaves are gathered over model there
    too), their gradients synchronised as its backward ends: the losses,
    parameters and moments after three steps equal the whole-gather step's
    on every rank, bit for bit; collectives issued are the plan's; the
    held-bytes peak within the bound, the whole-gather step's above it."""
    for r in ranks["got"]["4"]:
        R.check_per_period(r[f"pp/{config}/{remat}"])


def test_checkpoints_across_worlds_with_a_model_axis(ranks, tmp_path):
    """Saved at (1, 2) every 2 steps and resumed at step 4 on one device and
    at (2, 1); saved on one device at step 2 and resumed at (2, 2): each
    continues an uninterrupted one-device run's losses within PORT_TOL.
    The file is the one-device format: its step-4 parameters (the packed
    SwiGLU matrices unpacked) are a one-device run's after 4 steps."""
    whole = ranks["one"]["whole"]
    for r in ranks["got"]["2"]:
        save = r["ckpt/save12"]
        assert save["final_step"] == 4
        np.testing.assert_allclose(save["losses"], whole[:4], **PORT_TOL)
        np.testing.assert_allclose(save["whole"], whole, **PORT_TOL)
        resumed = r["ckpt/resume21"]
        assert resumed["final_step"] == 6
        np.testing.assert_allclose(resumed["losses"], whole[4:], **PORT_TOL)
    for r in ranks["got"]["4"]:
        resumed = r["ckpt/resume22"]
        assert resumed["final_step"] == 4
        np.testing.assert_allclose(resumed["losses"], whole[2:4], **PORT_TOL)
    d = str(tmp_path / "ck")
    shutil.copytree(os.path.join(ranks["work"], "ck12"), d)
    shutil.rmtree(os.path.join(d, "step_00000006"))  # resume the (1, 2) step 4
    one = train_mod.train(configs.get_reduced(DENSE), steps=2, ckpt_dir=d, ckpt_every=2,
                          global_batch=R.BATCH, seq_len=R.SEQ, opt=R.optimizer(),
                          params=ranks["params"][DENSE], device="cpu")
    np.testing.assert_allclose(one["losses"], whole[4:], **PORT_TOL)
    saved = _restored_params(os.path.join(ranks["work"], "ck12"), 4)
    p4 = {k: v for k, v in ranks["one"]["p4"].items() if k.startswith("params/")}
    _state_close({f"params/{k}": v for k, v in saved.items()}, p4, R.optimizer().peak_lr)


def _restored_params(directory, step):
    """The parameters of a committed step of a reduced Qwen2-1.5B run."""
    from repro_torch.checkpoint import store

    params = dict(Transformer(configs.get_reduced(DENSE), device="cpu",
                              seed=0).named_parameters())
    tree, _ = store.restore(directory, step, {"params": params,
                                              "opt": R.optimizer().init(params)})
    return {k: np.asarray(v) for k, v in tree["params"].items()}


def test_reference_gspmd_collectives_beside_the_plan(ranks):
    """The JAX package's compiled train step of reduced Qwen2-1.5B on a
    (1, 2) host mesh, parsed by ``launch/hlo_analysis.py``, beside the
    port's plan for the same step (batch 4 x 16 + 1 tokens): GSPMD's
    collectives are not Megatron's (it also moves data by all-gather,
    all-to-all and collective-permute), so only what both must share is
    held: each sums over the model axis, and the port issues nothing but
    all_reduces there when the KV heads split (ROADMAP Queue 3)."""
    gspmd = hlo_analysis.collective_bytes(ranks["ref"]["hlo"])
    cfg = configs.get_reduced(DENSE)
    plan = DataParallelPlan(cfg, M.abstract_params(cfg), AbstractMesh((1, 2), ("data", "model")),
                            R.optimizer())
    port = plan.collective_bytes("train", R.BATCH, R.SEQ)
    assert gspmd["all-reduce"] > 0 and gspmd["total"] > 0, gspmd
    assert port["all-reduce"] > 0 and port["all-gather"] == port["reduce-scatter"] == 0, port
    issued = ranks["got"]["2"][0][f"train/{DENSE}/1x2"]["issued"]
    assert {k: v * R.STEPS for k, v in port.items() if k != "total"} == issued
    assert set(gspmd) >= {"all-reduce", "all-gather", "all-to-all", "collective-permute"}


def test_reference_gspmd_all_gather_beside_the_per_period_plan(ranks, capsys):
    """A recorded comparison (PERF.md), not a gate: the JAX package's
    compiled train step of reduced Qwen2-1.5B on a (2, 1) host mesh, parsed
    by ``launch/hlo_analysis.py`` (each instruction once, a scan body's
    whatever its trip count), beside the port's per-period plan for the
    same step.  The reference gathers the embedding and the token ids once
    and a period's leaves in its forward scan's body and again in its
    backward's (the recompute); the port gathers the embedding once and
    each of the 2 periods' leaves twice."""
    gspmd = hlo_analysis.collective_bytes(ranks["ref"]["hlo_2x1"])
    cfg = configs.get_reduced(DENSE)
    plan = DataParallelPlan(cfg, M.abstract_params(cfg), AbstractMesh((2, 1), ("data", "model")),
                            R.optimizer())
    port = plan.collective_bytes("train", R.BATCH, R.SEQ)
    once = sum(plan._compute_bytes(k) for k in plan.sharded())  # every leaf gathered once
    with capsys.disabled():
        print(f"\nreduced {DENSE} on (2, 1): the reference's compiled all-gather "
              f"{gspmd['all-gather']} B (static), all-reduce {gspmd['all-reduce']} B, "
              f"reduce-scatter {gspmd['reduce-scatter']} B; the port's per-period plan "
              f"{port['all-gather']} B a step ({once} B gathering each leaf once)")
    assert gspmd["all-gather"] > 0
    assert once < port["all-gather"] < 2 * once


# ---------------------------------------------------------------------------
# Without processes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "jamba-1.5-large-398b", "hubert-xlarge"])
def test_item_14k_configs_raise(arch):
    """Item 14k's configs -- SSM mixers and the frames frontend -- no longer
    raise on a model axis: ``check_config`` takes them at k = 2, and the
    plan on a (1, 2) mesh cuts their leaves (packed mixer matrices in 2 or
    4 parts, mLSTM head projections by head, a gathered ``embed_proj``) and
    marks the replicated leaves a rank uses in part."""
    cfg = configs.get_reduced(arch)
    tp.check_config(cfg, 2)
    plan = DataParallelPlan(cfg, M.abstract_params(cfg), _FakeMesh(1, 2, 0))
    leaves = {k.rsplit(".", 1)[-1]: v for k, v in plan.leaves.items()}
    if arch == "xlstm-1.3b":
        assert leaves["w_up"].packed == 2 and leaves["w"].packed == 4
        assert leaves["wq"].mdim == 0 and leaves["r"].partial and leaves["w_if"].partial
    elif arch == "jamba-1.5-large-398b":
        mamba = plan.leaves["blocks.0.w_in"]  # the period's first sub-block
        assert mamba.packed == 2 and leaves["w_x"].mdim == 0
    else:
        assert leaves["embed_proj"].gathered and not leaves["embed_proj"].partial
    tp.check_config(cfg, 1)


def test_uneven_splits_and_int8_moments_raise():
    """Heads, channels or experts a model axis does not divide raise
    ``ValueError`` naming the config and k (the mixers' too); 8-bit moments
    on a model axis plan (whole moments, every leaf's)."""
    cfg = configs.get_reduced(DENSE)
    with pytest.raises(ValueError, match="qwen2-1.5b.*4 attention heads.*model axis of 3"):
        tp.check_config(cfg, 3)
    kimi = dataclasses.replace(configs.get_reduced(KIMI), n_heads=6, n_kv_heads=3)
    with pytest.raises(ValueError, match="8 experts.*model axis of 3"):
        tp.check_config(kimi, 3)
    with pytest.raises(ValueError, match="xlstm-1.3b-smoke: 4 mLSTM heads.*model axis of 8"):
        tp.check_config(configs.get_reduced("xlstm-1.3b"), 8)
    slstm = dataclasses.replace(configs.get_reduced("xlstm-1.3b"), period=("slstm",))
    with pytest.raises(ValueError, match="4 sLSTM heads.*model axis of 3"):
        tp.check_config(slstm, 3)
    jamba = dataclasses.replace(configs.get_reduced("jamba-1.5-large-398b"), n_heads=6,
                                n_kv_heads=3, d_ff=96, moe=None, period=("mamba", "attn"))
    with pytest.raises(ValueError, match="128 Mamba channels.*model axis of 3"):
        tp.check_config(jamba, 3)
    plan = DataParallelPlan(cfg, M.abstract_params(cfg), AbstractMesh((1, 2), ("data", "model")),
                            AdamW(quantize_states=True))
    assert plan.whole_moments and plan.refusal is None


def test_at_rest_bytes_halve_the_cut_leaves():
    """Reduced Qwen2-1.5B in fp32 with fp32 moments (12 bytes an entry): the
    leaves a model axis of 2 cuts (embedding, every attention and MLP matrix
    and bias: 90,368 entries) are held in half, the norms (320) whole."""
    cfg = configs.get_reduced(DENSE)
    params = M.abstract_params(cfg)
    one = DataParallelPlan(cfg, params, None, R.optimizer())
    two = DataParallelPlan(cfg, params, AbstractMesh((1, 2), ("data", "model")), R.optimizer())
    assert one.at_rest_bytes() == (90_368 + 320) * 12 == 1_088_256
    assert two.at_rest_bytes() == (90_368 // 2 + 320) * 12 == 546_048
    assert sum(p.numel() for p in params.parameters()) == 90_368 + 320


def test_packed_swiglu_blocks():
    """``pack_columns`` puts ``[gate_r | up_r]`` in rank r's contiguous block
    (the SwiGLU of each block is its columns of the one-device SwiGLU's
    hidden layer) and ``unpack_columns`` undoes it."""
    rng = np.random.default_rng(0)
    w_in = torch.from_numpy(rng.standard_normal((8, 24)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((5, 8)).astype(np.float32))
    gate, up = (x @ w_in).chunk(2, dim=-1)
    hidden = torch.nn.functional.silu(gate) * up  # (5, 12)
    for k in (2, 3, 4):
        packed = tp.pack_columns(w_in, k)
        assert torch.equal(tp.unpack_columns(packed, k), w_in)
        for r, block in enumerate(packed.chunk(k, dim=-1)):
            g, u = (x @ block).chunk(2, dim=-1)
            f = 12 // k
            torch.testing.assert_close(torch.nn.functional.silu(g) * u,
                                       hidden[:, r * f:(r + 1) * f], rtol=0, atol=0)


def test_recompute_re_enters_the_model_axis():
    """A remat recompute runs on autograd's device thread without the
    forward's context: ``recompute_context`` carries the model axis too."""
    ms = hints.ModelShards(None, 2, 1, None)
    with hints.use_model_shards(ms):
        ctx = hints.recompute_context()
    assert hints.model_shards() is None
    with ctx:
        assert hints.model_shards() is ms
    assert hints.model_shards() is None


class _FakeMesh:
    """One rank's view of a (data d, model m) DeviceMesh, without processes."""

    mesh_dim_names = ("data", "model")
    device_type = "cpu"

    def __init__(self, d, m, rank):
        self.shape, self.rank = (d, m), rank

    def size(self):
        return self.shape[0] * self.shape[1]

    def get_coordinate(self):
        return divmod(self.rank, self.shape[1])

    def get_group(self, axis):
        return None


@pytest.mark.parametrize("d, m", [(1, 2), (2, 2)])
def test_batch_for_mesh_rows_on_a_model_axis(d, m):
    """``batch_for_mesh`` splits over the data axes only: every rank of a
    model group takes the same rows, and the data groups' rows laid end to
    end are the global batch."""
    cfg = lm_data.PipelineConfig(vocab_size=97, seq_len=9, global_batch=4, seed=3)
    rows = [lm_data.batch_for_mesh(cfg, 1, _FakeMesh(d, m, r), device="cpu")
            for r in range(d * m)]
    for group in _model_groups(f"{d}x{m}"):
        for r in group[1:]:
            assert torch.equal(rows[r], rows[group[0]])
    whole = torch.cat([rows[g[0]] for g in _model_groups(f"{d}x{m}")]).numpy()
    np.testing.assert_array_equal(whole, lm_data.global_batch_at(cfg, 1))
