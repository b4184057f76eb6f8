"""Tensor parallelism for the SSM mixers, the frames frontend and 8-bit
moments on the CPU: xLSTM (mLSTM + sLSTM), Jamba (Mamba + attention + MoE)
and HuBERT (frames in, 64 classes; and 63, which no model axis here
divides: a whole head on every rank) trained, xLSTM and Jamba served, and
reduced Qwen2-1.5B trained with ``AdamW(quantize_states=True)``, each on
(data, model) meshes (1, 2), (2, 2) and (1, 4).

The ranks are gloo processes spawned once for the module
(``_torch_tensor_parallel_ranks.py``, a world of 2 and one of 4), beside three
subprocesses that run the JAX package's ``train`` (its ``make_step`` on
frames and labels for HuBERT) and ``serve`` on host meshes of 4 devices,
compiled with ``jax_disable_most_optimizations`` as
``tests/test_torch_tensor_parallel.py``'s are.  The reference's jobs are this
module's critical path, so they run (1, 2) for every config and (2, 2) only
for HuBERT and the 8-bit moments: its (2, 2) losses of xLSTM and Jamba
equal its (1, 2) ones to about 1e-7, and the port's (2, 2) and (1, 4) runs
of them are held against the port's one-device run, itself within
``PORT_TOL`` of the reference's.  Every run starts from the JAX package's
initial parameters, converted, all fp32.

Tolerances: as ``tests/test_torch_tensor_parallel.py``'s (``PORT_TOL`` rtol
1e-5 for losses, ``GRAD_TOL`` for step 0's gradients leaf by leaf, the Adam
rule for the parameters after three steps); an 8-bit moment's int8 blocks
may round one unit apart where the sums ran in another order, so its state
is held by the parameters.
"""

import dataclasses
import functools
import json
import math
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
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import train as train_mod
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import hints, ssm
from repro_torch.models import model as M
from repro_torch.models.model import Transformer
from repro_torch.optim import AdamW
from repro_torch.runtime import tensor_parallel as tp
from repro_torch.runtime.data_parallel import DataParallelPlan

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
RANK_TIMEOUT_S = 240
PORT_TOL = dict(rtol=1e-5, atol=1e-6)
# a gradient entry is a sum of the model ranks' partial sums, carried through the
# mixers' recurrences (exp gates, the sLSTM's time loop): fp32 reordering reaches
# ~4e-6 of the leaf's largest entry (xLSTM at (1, 2)), where a missing sum moves it
# by O(1)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
# served logits: the same reordering through the recurrences, the atol
# relative to the largest logit (3.0e-6 at a logit near 0 seen at (1, 2))
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)

XLSTM, JAMBA, HUBERT, DENSE = ("xlstm-1.3b", "jamba-1.5-large-398b", "hubert-xlarge",
                               "qwen2-1.5b")
# each variant: an arch, the vocabulary where it is not the config's, the
# name of its initial parameters' file, 8-bit moments
VARIANTS = {"xlstm": dict(arch=XLSTM), "jamba": dict(arch=JAMBA),
            "hubert": dict(arch=HUBERT),
            "hubert-v63": dict(arch=HUBERT, vocab=63, params="hubert-v63"),
            "int8": dict(arch=DENSE, int8=True)}
MESHES = ("1x2", "2x2", "1x4")
TRAIN = [(v, m) for v in VARIANTS for m in MESHES]
SERVE = [(v, m) for v in ("xlstm", "jamba") for m in MESHES]
# the reference's train runs (see the module docstring), by mesh
REF_TRAIN = {"1x2": tuple(VARIANTS), "2x2": ("hubert", "hubert-v63", "int8")}
CONTROLS = {"mamba_g": "jamba", "r_unsummed": "xlstm"}
# the per-period step against the whole-gather step on (data 2, model 2):
# Jamba (Mamba + MoE on the model axis, its two-way sums inside every
# period) at 2 periods from the port's seeded init, under each remat; and
# xLSTM (mLSTM heads at rest, the sLSTM's 4-part packed blocks) under full
PER_PERIOD = [("jamba", "full"), ("jamba", "dots"), ("jamba", "off"), ("xlstm", "full")]
PP_CONFIGS = {"jamba": dict(arch=JAMBA, periods=2, random=True), "xlstm": dict(arch=XLSTM)}
CKPT = dict(arch=XLSTM, int8=True)  # mLSTM heads, sLSTM 4-part blocks, int8 moments


def _cases(kind, runs, world):
    return [dict(name=f"{kind}/{v}/{m}", kind=kind, mesh=[int(x) for x in m.split("x")],
                 **VARIANTS[v]) for v, m in runs if (m == "1x2") == (world == "2")]


CASES = {
    "2": dict(cases=[
        dict(name="sum", kind="sum", mesh=[1, 2]),
        *_cases("train", TRAIN, "2"),
        *_cases("serve", SERVE, "2"),
        *[dict(name=f"control/{c}", kind="control", mesh=[1, 2], control=c,
               **VARIANTS[a]) for c, a in CONTROLS.items()],
        # save at (1, 2) every 2 steps, then resume its step 4 at (2, 1)
        dict(name="ckpt/save12", kind="ckpt", mesh=[1, 2], dir="ck12", steps=4, whole=6,
             **CKPT),
        dict(name="ckpt/resume21", kind="ckpt", mesh=[2, 1], dir="ck12", steps=2, **CKPT),
    ]),
    "4": dict(cases=[*_cases("train", TRAIN, "4"), *_cases("serve", SERVE, "4"),
                     *[dict(name=f"pp/{c}/{r}", kind="per_period", mesh=[2, 2], remat=r,
                            **PP_CONFIGS[c]) for c, r in PER_PERIOD]]),
}

# The JAX package's runs, in three processes (argv[1]: one of REF_JOBS):
# train on (1, 2) and (2, 2) meshes of 4 host devices (HuBERT through its
# make_sharded_train_state / make_step on TPR.frames_batch's values: the same
# frame_embeddings, labels drawn from the step), serve on (1, 2).
REF_MESH = textwrap.dedent("""
    import dataclasses, json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh
    from repro import configs
    from repro.data import lm
    from repro.launch import serve, train
    from repro.optim import AdamW
    jax.config.update("jax_disable_most_optimizations", True)
    assert len(jax.devices()) == 4
    meshes = {s: Mesh(np.array(jax.devices()[:d * m]).reshape(d, m), ("data", "model"))
              for s, (d, m) in (("1x2", (1, 2)), ("2x2", (2, 2)))}
    B, S = 4, 16

    def opt(int8=False):
        return AdamW(peak_lr=1e-3, warmup_steps=1, total_steps=6, quantize_states=int8)

    def config(spec):
        cfg = configs.get_reduced(spec["arch"])
        return dataclasses.replace(cfg, vocab_size=spec["vocab"]) if spec.get("vocab") else cfg

    def frames_train(cfg, mesh, steps=3):
        o = opt()
        params, st, pshard, sshard = train.make_sharded_train_state(cfg, o, mesh, 0)
        step = train.make_step(cfg, o, mesh, pshard, sshard)
        losses = []
        for i in range(steps):
            frames = lm.frame_embeddings(cfg.d_model, S, B, seed=0, step=i)
            labels = np.random.default_rng(i).integers(0, cfg.vocab_size, (B, S))
            with mesh:
                loss, params, st = step(params, st, {"frames": frames,
                                                     "labels": jnp.asarray(labels, jnp.int32)})
            losses.append(float(loss))
        return losses

    job = json.loads(sys.argv[1])
    out = {"serve": {}}
    for shape, names in job["train"].items():
        out[shape] = {}
        for name in names:
            spec = job["variants"][name]
            cfg = config(spec)
            if cfg.frontend == "frames":
                out[shape][name] = frames_train(cfg, meshes[shape])
            else:
                out[shape][name] = train.train(cfg, steps=3, global_batch=B, seq_len=S,
                                               mesh=meshes[shape], log_every=1000,
                                               opt=opt(spec.get("int8", False)))["losses"]
    for arch in job["serve"]:
        got = serve.serve(configs.get_reduced(arch), batch=B, prompt_len=S, gen_tokens=4,
                          seed=0, mesh=meshes["1x2"])
        out["serve"][arch] = np.asarray(got["generated"]).tolist()
    print(json.dumps(out))
""")
REF_JOBS = [dict(train={"1x2": ["jamba"]}, serve=[JAMBA]),
            dict(train={"1x2": ["xlstm"]}, serve=[XLSTM]),
            dict(train={"1x2": ["hubert", "hubert-v63", "int8"],
                        "2x2": list(REF_TRAIN["2x2"])}, serve=[])]


def _jax_config(spec):
    jcfg = jconfigs.get_reduced(spec["arch"])
    return dataclasses.replace(jcfg, vocab_size=spec["vocab"]) if spec.get("vocab") else jcfg


def _ref_params(spec, jit=True):
    """The JAX package's initial parameters, seed 0, as the port's state
    dict: jitted as its ``train`` draws them, or eager as its ``serve``."""
    jcfg = _jax_config(spec)
    init = functools.partial(JM.init_params, cfg=jcfg)
    jp = (jax.jit(init) if jit else init)(jax.random.PRNGKey(0))
    return lm_params_from_reference(jax.tree.map(np.asarray, jp), TPR.case_config(spec))


def _env():
    return dict(os.environ, PYTHONPATH=SRC + os.pathsep + HERE + os.pathsep
                + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")


def _one_device(spec, params):
    """The one-device run a variant is held to: its steps' losses and state,
    and step 0's loss and gradients."""
    cfg = TPR.case_config(spec)
    out = TPR.run_steps(cfg, params, None, TPR.optimizer(spec))
    model = Transformer.from_params(cfg, params, device="cpu")
    loss0, grads = M.loss_and_grads(model, TPR.batch_at(cfg, 0, None))
    out.update(loss0=float(loss0.detach()), grads={k: v.numpy() for k, v in grads.items()})
    return out


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One thread for this module's one-device runs: the rank processes and
    the reference's jobs have the other cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _save(work, name, params):
    """``params`` to ``work/<name>.npz``, moved into place whole (the ranks
    wait for it)."""
    tmp = os.path.join(work, f"{name}.tmp.npz")
    np.savez(tmp, **{k: t.numpy() for k, t in params.items()})
    os.replace(tmp, os.path.join(work, f"{name}.npz"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawn the reference's three jobs and both worlds once; meanwhile, the
    initial parameters (which the ranks wait for, case by case) and the
    one-device runs to compare."""
    work = str(tmp_path_factory.mktemp("tensor_parallel_ssm"))
    with open(os.path.join(work, "cases.json"), "w") as f:
        json.dump(CASES, f)
    every = [subprocess.Popen([sys.executable, "-c", REF_MESH,
                               json.dumps(dict(job, variants=VARIANTS))], env=_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for job in REF_JOBS]
    refs = list(every)
    try:
        for w in CASES:
            every += [subprocess.Popen([sys.executable,
                                        os.path.join(HERE, "_torch_tensor_parallel_ranks.py"),
                                        str(r), w, work], env=_env(), stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)
                      for r in range(int(w))]
        params = {}
        for v, spec in VARIANTS.items():  # in the order of the ranks' cases
            params[v] = _ref_params(spec)
            _save(work, spec.get("params", spec["arch"]), params[v])
        served = {}
        for v in ("xlstm", "jamba"):
            served[v] = _ref_params(VARIANTS[v], jit=False)
            _save(work, f"{VARIANTS[v]['arch']}_serve", served[v])
        one = {v: _one_device(spec, params[v]) for v, spec in VARIANTS.items()}
        for v in served:
            one[v]["serve"] = serve_mod.serve(configs.get_reduced(VARIANTS[v]["arch"]),
                                              params=served[v], device="cpu", **R.SERVE)
        cfg, opt = TPR.case_config(CKPT), TPR.optimizer(CKPT)
        one["whole"] = train_mod.train(cfg, steps=6, global_batch=R.BATCH, seq_len=R.SEQ,
                                       opt=opt, params=params["xlstm"], device="cpu")["losses"]
        one["p4"] = R.run_steps(cfg, params["xlstm"], None, opt, steps=4)["state"]
        outs, errs = {}, []
        for p in every:
            out, err = p.communicate(timeout=RANK_TIMEOUT_S)
            outs[p] = out
            if p.returncode:
                errs.append(err[-3000:])
        assert not errs, errs
        ref = {"serve": {}}
        for p in refs:
            got = json.loads(outs[p].strip().splitlines()[-1])
            for shape, runs in got.items():
                ref.setdefault(shape, {}).update(runs)
    finally:
        for p in every:
            if p.poll() is None:
                p.kill()
                p.wait()
    got = {w: [torch.load(os.path.join(work, f"world{w}_rank{r}.pt"), weights_only=False)
               for r in range(int(w))] for w in CASES}
    return dict(work=work, params=params, got=got, one=one, ref=ref)


def _runs(ranks, mesh):
    return ranks["got"]["2" if mesh == "1x2" else "4"]


def _grad_close(got, want) -> bool:
    """GRAD_TOL, its atol relative to the leaf's largest entry."""
    return np.allclose(got, want, rtol=GRAD_TOL["rtol"],
                       atol=GRAD_TOL["atol"] * max(float(np.abs(want).max()), 1.0))


def _state_close(got, want, lr):
    """``tests/test_torch_train_mesh.py``'s rule on the fp32 state: every
    parameter entry within 3 lr, all but 0.1% of the entries within rtol
    1e-4 / atol 1e-5 (an 8-bit moment is held by its parameter alone)."""
    off = total = 0
    for k, w in want.items():
        if k.endswith(("/q", "/scale")):
            continue
        g = got[k]
        if k.startswith("params/"):
            assert np.abs(g - w).max() <= 3 * lr, k
        off += int(np.sum(np.abs(g - w) > 1e-5 + 1e-4 * np.abs(w)))
        total += w.size
    assert off <= 1e-3 * total, (off, total)


# ---------------------------------------------------------------------------
# With processes
# ---------------------------------------------------------------------------


def test_two_way_sum_matches_its_definition(ranks):
    """``sum_over_model`` on two model ranks feeding x_r and backpropagating
    w_r: x_0 + x_1 forward and w_0 + w_1 backward on each (``g`` would give
    w_r), one counted all_reduce each way."""
    xs = [torch.arange(6.0).reshape(2, 3) + 10.0 * r for r in range(2)]
    ws = [torch.full((2, 3), 1.0 + r) for r in range(2)]
    for res in ranks["got"]["2"]:
        res = res["sum"]
        torch.testing.assert_close(res["y"], xs[0] + xs[1], rtol=0, atol=0)
        torch.testing.assert_close(res["grad"], ws[0] + ws[1], rtol=0, atol=0)
        assert res["issued"] == {"all-reduce": 2 * 24, "all-gather": 0, "reduce-scatter": 0}


@pytest.mark.parametrize("variant, mesh", TRAIN, ids=[f"{v}-{m}" for v, m in TRAIN])
def test_losses_match_one_device_and_reference(ranks, variant, mesh):
    """Every rank's losses are equal bit for bit, within PORT_TOL of the
    port's one-device run and of the JAX package's on the same host mesh
    where it ran there (else on (1, 2): the module docstring)."""
    runs = [r[f"train/{variant}/{mesh}"] for r in _runs(ranks, mesh)]
    for r in runs:
        assert r["losses"] == runs[0]["losses"]
    np.testing.assert_allclose(runs[0]["losses"], ranks["one"][variant]["losses"], **PORT_TOL)
    ref_mesh = mesh if variant in REF_TRAIN.get(mesh, ()) else "1x2"
    np.testing.assert_allclose(runs[0]["losses"], ranks["ref"][ref_mesh][variant], **PORT_TOL)
    np.testing.assert_allclose(ranks["one"][variant]["losses"], ranks["ref"]["1x2"][variant],
                               **PORT_TOL)


@pytest.mark.parametrize("variant, mesh", TRAIN, ids=[f"{v}-{m}" for v, m in TRAIN])
def test_grads_and_params_match_one_device(ranks, variant, mesh):
    """Step 0's gradients, synchronised over both axes and gathered into the
    one-device layout (packed matrices unpacked, mLSTM heads in order), leaf
    by leaf within GRAD_TOL of one device's; the gathered state after three
    steps equal on every rank bit for bit (8-bit moments included) and
    within the Adam rule of one device's."""
    one = ranks["one"][variant]
    runs = [r[f"train/{variant}/{mesh}"] for r in _runs(ranks, mesh)]
    np.testing.assert_allclose(runs[0]["loss0"], one["loss0"], **PORT_TOL)
    for k, g1 in one["grads"].items():
        assert _grad_close(runs[0]["grads"][k], g1), k
    for r in runs[1:]:
        for k, v in runs[0]["state"].items():
            assert v.tobytes() == r["state"][k].tobytes(), k
    assert set(runs[0]["state"]) == set(one["state"])
    _state_close(runs[0]["state"], one["state"], R.optimizer().peak_lr)


@pytest.mark.parametrize("variant, mesh", TRAIN, ids=[f"{v}-{m}" for v, m in TRAIN])
def test_collectives_and_held_bytes_equal_the_plan(ranks, variant, mesh):
    """Every collective the ranks issued, counted by the transport, equals
    ``plan.collective_bytes()`` by kind (the mixers' two-way sums, the
    gathered ``embed_proj``, the 8-bit moments' gradient gathers included);
    the bytes a rank holds between steps equal ``at_rest_bytes`` (int8
    moments of the whole leaves)."""
    for r in _runs(ranks, mesh):
        r = r[f"train/{variant}/{mesh}"]
        assert r["issued"] == r["want"]
        assert r["want"]["all-reduce"] > 0
        assert r["held"] == r["at_rest"]


@pytest.mark.parametrize("variant, mesh", SERVE, ids=[f"{v}-{m}" for v, m in SERVE])
def test_serve_matches_one_device_and_reference(ranks, variant, mesh):
    """``serve(mesh=)`` with per-rank recurrent states: every rank returns
    the whole batch's tokens, one device's and the JAX package's on a (1, 2)
    host mesh; its prefill logits (gathered over the model axis) are its
    rows' of one device's; a rank holds 1/k of each leaf the model axis
    cuts and the others whole."""
    one = ranks["one"][variant]["serve"]
    runs = [r[f"serve/{variant}/{mesh}"] for r in _runs(ranks, mesh)]
    d, m = (int(s) for s in mesh.split("x"))
    n = R.BATCH // d
    cfg = configs.get_reduced(VARIANTS[variant]["arch"])
    plan = DataParallelPlan(cfg, M.abstract_params(cfg), AbstractMesh((d, m), ("data", "model")))
    whole = sum(math.prod(leaf.shape) * leaf.dtype.itemsize for leaf in plan.leaves.values()
                if leaf.mdim is None)
    for i, r in enumerate(runs):
        np.testing.assert_array_equal(r["generated"], one["generated"])
        np.testing.assert_array_equal(r["generated"],
                                      ranks["ref"]["serve"][VARIANTS[variant]["arch"]])
        lo = (i // m) * n
        want = one["prefill_logits"][lo:lo + n].numpy()
        np.testing.assert_allclose(r["logits"].numpy(), want, rtol=LOGIT_TOL["rtol"],
                                   atol=LOGIT_TOL["atol"] * float(np.abs(want).max()))
        assert r["at_rest"] == (one["at_rest_bytes"] - whole) // m + whole


@pytest.mark.parametrize("control", list(CONTROLS))
def test_controls_fail_the_gates(ranks, control):
    """Each fault fails a gate the sound runs pass (the loss gate, step 0's
    gradients within GRAD_TOL, or the parameters' 3 lr rule): Mamba's
    ``xin @ w_x`` summed by ``g`` alone (the partial gradients of the
    channels it feeds are not summed back), and the sLSTM's ``r`` gradient
    left unsummed over the model axis."""
    variant = CONTROLS[control]
    res = ranks["got"]["2"][0][f"control/{control}"]
    one = ranks["one"][variant]
    loss_bad = not np.allclose(res["losses"], one["losses"], **PORT_TOL)
    grads_bad = [k for k, g1 in one["grads"].items() if not _grad_close(res["grads"][k], g1)]
    params_bad = any(np.abs(res["state"][k] - w).max() > 3 * R.optimizer().peak_lr
                     for k, w in one["state"].items() if k.startswith("params/"))
    assert loss_bad or grads_bad or params_bad
    if control == "r_unsummed":  # the forward is sound: only r's gradient is off
        np.testing.assert_allclose(res["losses"][0], one["losses"][0], **PORT_TOL)
        assert grads_bad and all(k.endswith(".r") for k in grads_bad), grads_bad


@pytest.mark.parametrize("config, remat", PER_PERIOD, ids=[f"{c}-{r}" for c, r in PER_PERIOD])
def test_per_period_step_equals_whole_gather_step(ranks, config, remat):
    """On (data 2, model 2) each period's leaves gathered inside the period,
    again in its recompute: Jamba's (Mamba's packed ``w_in`` blocks, the
    expert stacks cut over both axes) beside the Mamba layers' two-way sums
    and the global dispatch's gathers, under remat ``full``, ``dots`` and
    off; xLSTM's (mLSTM head projections held as heads, the sLSTM's 4-part
    packed ``w``) beside the mLSTM's two-way sums.  The losses, parameters
    and moments after three steps equal the whole-gather step's on every
    rank, bit for bit; collectives issued are the plan's; the held-bytes
    peak within the bound."""
    for r in ranks["got"]["4"]:
        R.check_per_period(r[f"pp/{config}/{remat}"])


@pytest.mark.parametrize("arch", [DENSE, JAMBA, XLSTM])
def test_per_period_only_where_a_period_leaf_is_cut_over_data(arch):
    """The plan gathers a period's leaves inside it on a data axis larger
    than 1 with fp32 moments; with 8-bit moments (every leaf replicated over
    data, as the reference's ``state_specs`` keeps them), for serving (no
    optimizer: every leaf replicated) and on a model axis alone it keeps
    the whole-step path, and its bound is the whole step's (as with one
    period: reduced Jamba's)."""
    cfg = configs.get_reduced(arch)
    params = M.abstract_params(cfg)
    for shape, opt, cut in (((2, 2), R.optimizer(), True), ((2, 1), R.optimizer(), True),
                            ((2, 2), AdamW(quantize_states=True), False),
                            ((2, 2), None, False), ((1, 2), R.optimizer(), False)):
        plan = DataParallelPlan(cfg, params, AbstractMesh(shape, ("data", "model")), opt)
        assert bool(plan.per_period) == cut, (shape, opt)
        if cut:
            assert all(k.startswith("blocks.") for k in plan.per_period)
            # below the whole step's where there is more than one period
            assert (plan.held_bound() < plan.whole_step_bytes()) == (cfg.n_periods > 1)
        else:
            assert plan.held_bound() == plan.whole_step_bytes()


def test_checkpoints_across_worlds_with_new_layouts(ranks):
    """xLSTM with 8-bit moments saved at (1, 2) every 2 steps (its mLSTM
    head projections held as heads, its sLSTM ``w`` as 4-part blocks, its
    moments whole) and resumed at step 4 at (2, 1) and on one device: each
    continues an uninterrupted one-device run's losses within PORT_TOL.  The
    file is the one-device format: its step-4 parameters are a one-device
    run's after 4 steps, and it restores into a one-device state tree."""
    whole = ranks["one"]["whole"]
    for r in ranks["got"]["2"]:
        save = r["ckpt/save12"]
        assert save["final_step"] == 4
        np.testing.assert_allclose(save["losses"], whole[:4], **PORT_TOL)
        np.testing.assert_allclose(save["whole"], whole, **PORT_TOL)
        resumed = r["ckpt/resume21"]
        assert resumed["final_step"] == 6
        np.testing.assert_allclose(resumed["losses"], whole[4:], **PORT_TOL)
    from repro_torch.checkpoint import store

    cfg, opt = TPR.case_config(CKPT), TPR.optimizer(CKPT)
    d = os.path.join(ranks["work"], "ck12")
    resumed = train_mod.train(cfg, steps=2, ckpt_dir=shutil.copytree(
        d, os.path.join(ranks["work"], "ck12_one"), ignore=shutil.ignore_patterns(
            "step_00000006")), ckpt_every=2, global_batch=R.BATCH, seq_len=R.SEQ, opt=opt,
        params=ranks["params"]["xlstm"], device="cpu")
    np.testing.assert_allclose(resumed["losses"], whole[4:], **PORT_TOL)
    params = dict(Transformer(cfg, device="cpu", seed=0).named_parameters())
    tree, _ = store.restore(d, 4, {"params": params, "opt": opt.init(params)})
    got = {f"params/{k}": np.asarray(v) for k, v in tree["params"].items()}
    _state_close(got, {k: v for k, v in ranks["one"]["p4"].items() if k.startswith("params/")},
                 R.optimizer().peak_lr)
    for k, (q, scale) in tree["opt"].mu.items():
        assert np.asarray(q).dtype == np.int8 and np.asarray(q).size >= params[k].numel(), k


# ---------------------------------------------------------------------------
# Without processes
# ---------------------------------------------------------------------------


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


@pytest.mark.parametrize("arch", [XLSTM, JAMBA])
def test_decode_state_per_rank(arch):
    """A rank of a model axis of 2 serving (its weights cut by the plan):
    its recurrent states hold its channels or heads -- Mamba (B, d_conv - 1,
    di / 2) and (B, di / 2, ds), mLSTM H / 2 heads, sLSTM (B, d / 2) with m
    in fp32 -- the blocks of one device's, and an attention cache its KV
    heads."""
    cfg = configs.get_reduced(arch)
    B, S = 3, 8
    whole = Transformer(cfg, device="cpu", seed=0).init_cache(B, S)
    for r in range(2):
        model = Transformer(cfg, device="cpu", seed=0)
        plan = DataParallelPlan(cfg, model, _FakeMesh(1, 2, r))
        plan.gather_params(model, plan.shard_params(model))
        with plan.scope():
            cache = model.init_cache(B, S)
        for blk, c, w in zip(model.blocks, cache, whole):
            if isinstance(blk, ssm.Mamba):
                di = cfg.mamba.d_inner // 2
                assert c.conv.shape == (B, cfg.mamba.d_conv - 1, di)
                assert c.h.shape == (B, di, cfg.mamba.d_state)
            elif isinstance(blk, ssm.MLSTM):
                H, dh = cfg.mlstm.n_heads // 2, cfg.mlstm.d_inner // cfg.mlstm.n_heads
                assert (c.C.shape, c.n.shape, c.m.shape) == ((B, H, dh, dh), (B, H, dh), (B, H))
                assert c.conv.shape == (B, cfg.mlstm.d_conv - 1, H * dh)
            elif isinstance(blk, ssm.SLSTM):
                assert all(t.shape == (B, cfg.d_model // 2) for t in c)
                assert c.m.dtype == torch.float32 and c.h.dtype == torch.float32
            if c is not None:
                for t, tw in zip(c, w):  # one device's state, cut on one axis by 2
                    assert t.dtype == tw.dtype and t.numel() * 2 == tw.numel()


@pytest.mark.parametrize("k", [2, 4])
def test_four_part_blocks(k):
    """An sLSTM ``w`` ([i | f | z | o]) packed for k ranks: block r is
    ``[i_r | f_r | z_r | o_r]``, whose gates are the rank's heads' columns of
    the one-device gates; ``unpack_columns`` undoes it, and ``local_parts``
    cuts the bias the same way."""
    rng = np.random.default_rng(0)
    d = 16
    w = torch.from_numpy(rng.standard_normal((d, 4 * d)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(4 * d).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((5, d)).astype(np.float32))
    gates = (x @ w + b).reshape(5, 4, d)
    packed = tp.pack_columns(w, k, 4)
    assert torch.equal(tp.unpack_columns(packed, k, 4), w)
    n = d // k
    for r, block in enumerate(packed.chunk(k, dim=-1)):
        with hints.use_model_shards(hints.ModelShards(None, k, r, None)):
            br = tp.local_parts(b, 4)
        mine = (x @ block + br).reshape(5, 4, n)
        torch.testing.assert_close(mine, gates[:, :, r * n:(r + 1) * n], rtol=0, atol=0)


def test_undivided_vocabulary_stays_whole():
    """A vocabulary the model axis does not divide (63 classes over 2, as
    504 over 16): ``param_specs`` leaves the head whole, the plan does not
    cut it, gathers nothing for the logits and counts no CE reduction; a
    divided one is cut."""
    cfg = dataclasses.replace(configs.get_reduced(HUBERT), vocab_size=63)
    mesh = AbstractMesh((1, 2), ("data", "model"))
    plan = DataParallelPlan(cfg, M.abstract_params(cfg), mesh, R.optimizer())
    assert plan.leaves["head"].mdim is None and not plan.vocab_cut
    assert plan.leaves["embed_proj"].gathered and not plan.leaves["embed_proj"].partial
    t = torch.ones(2, 63)
    assert plan.gather_vocab(t) is t
    cut = DataParallelPlan(configs.get_reduced(HUBERT), M.abstract_params(
        configs.get_reduced(HUBERT)), mesh, R.optimizer())
    assert cut.leaves["head"].mdim == 1 and cut.vocab_cut
    T = R.BATCH * R.SEQ
    # the CE's three fp32 reductions a token and the head's f are the difference
    assert (cut.collective_bytes("train", R.BATCH, R.SEQ)["all-reduce"]
            - plan.collective_bytes("train", R.BATCH, R.SEQ)["all-reduce"]
            == 3 * T * 4 + T * cfg.d_model * 4)


def test_int8_moments_at_rest_on_a_model_axis():
    """Reduced Qwen2-1.5B in fp32 with 8-bit moments on (1, 2): a rank holds
    half of each cut leaf's parameters but every leaf's int8 blocks and
    scales whole (the one-device layout's), as the reference's
    ``state_specs`` replicates them."""
    cfg = configs.get_reduced(DENSE)
    params = M.abstract_params(cfg)
    opt = AdamW(quantize_states=True)
    one = DataParallelPlan(cfg, params, None, opt)
    two = DataParallelPlan(cfg, params, AbstractMesh((1, 2), ("data", "model")), opt)
    moments = sum(2 * (-(-p.numel() // 256)) * (256 + 4) for p in params.parameters())
    assert one.at_rest_bytes() == (90_368 + 320) * 4 + moments
    assert two.at_rest_bytes() == (90_368 // 2 + 320) * 4 + moments
    assert two.whole_moments and not one.whole_moments
