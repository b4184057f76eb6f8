"""LM training and serving over several ranks (``runtime/data_parallel.py``,
``launch/train.py`` ``make_sharded_train_state`` / ``make_step``,
``data/lm.py`` ``batch_for_mesh``, the MoE across ranks) on the CPU.

The ranks are gloo processes spawned once for the module
(``_torch_train_mesh_ranks.py``): a (data 2, model 1) world runs a dense
case, DeepSeek-V2-Lite (dropless MoE, global aux), Jamba (``dispatch=
"global"`` at capacity factor 1.25), Jamba under ``get_optimized``'s
rowwise dispatch, the checkpoint case and ``serve``; a (pod 2, data 2,
model 1) world runs the dense case.  Every case starts from the JAX package's initial
parameters, converted.  Both worlds also hold the per-period step against
the whole-gather step (``PER_PERIOD``) on (data 2, model 1) and (4, 1).

Tolerances: the ranks' losses and gathered states equal each other bit for
bit (every rank applies the same reduced gradients).  Against the port's
one-device run the gradients are the same fp32 sums in another order, so
the losses agree to ``PORT_TOL`` (rtol 1e-5) and the states by the rule of
``tests/test_torch_train.py`` (Adam moves a weight whose gradient is ~0 by
up to its learning rate whatever the rounding).  Against the JAX package's
``train`` (``jax.jit``, one host device; the rowwise case on a 2-device
host mesh in a subprocess) the losses agree to ``REF_TOL``, the
tolerance of ``tests/test_torch_train.py``'s three-step comparison.
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

import _torch_train_mesh_ranks as R
from repro import configs as jconfigs
from repro.data import lm as jlm
from repro.launch import train as jtrain
from repro.models import model as JM
from repro.optim import AdamW as JAdamW
from repro_torch import configs
from repro_torch.convert import lm_params_from_reference
from repro_torch.data import lm as lm_data
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import train as train_mod
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import hints, moe
from repro_torch.models import model as M
from repro_torch.models.model import Transformer, make_train_step
from repro_torch.optim import AdamW
from repro_torch.runtime.data_parallel import DataParallelPlan

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
HERE = os.path.dirname(os.path.abspath(__file__))
RANK_TIMEOUT_S = 240
PORT_TOL = dict(rtol=1e-5, atol=1e-6)
REF_TOL = dict(rtol=1e-4, atol=1e-5)
STATE_TOL = dict(rtol=1e-4, atol=1e-5)

DENSE, DEEPSEEK, JAMBA = "qwen2-1.5b", "deepseek-v2-lite-16b", "jamba-1.5-large-398b"
# the per-period step against the whole-gather step: each config by its
# label (DeepSeek's MoE at capacity factor 1.25, so that the global
# dispatch's count gather runs inside every period and its recompute; Jamba
# at 2 periods from the port's seeded init, its one period being the whole
# model), under each remat, on (data 2, model 1) and (4, 1)
PP_CONFIGS = {"dense": dict(arch=DENSE), "deepseek": dict(arch=DEEPSEEK, capacity=1.25),
              "jamba": dict(arch=JAMBA, periods=2)}
PER_PERIOD = ([(c, r, "2x1") for c in PP_CONFIGS for r in ("full", "dots", "off")]
              + [(c, "full", "4x1") for c in PP_CONFIGS])


def _pp_cases(world):
    return [dict(name=f"pp/{c}/{r}/{m}", kind="per_period", remat=r,
                 mesh=[int(x) for x in m.split("x")], **PP_CONFIGS[c])
            for c, r, m in PER_PERIOD if _world(m) == world]


def _world(mesh):
    d, m = (int(x) for x in mesh.split("x"))
    return str(d * m)


CASES = {
    "2": dict(shape=[2, 1], axes=["data", "model"], cases=[
        dict(name="dense", kind="train", arch=DENSE, driver=True),
        dict(name="deepseek", kind="train", arch=DEEPSEEK),
        dict(name="jamba", kind="train", arch=JAMBA, clip=None),
        dict(name="rowwise", kind="train", arch=JAMBA, dispatch="rowwise"),
        dict(name="jamba_keeps", kind="keeps", arch=JAMBA),
        dict(name="deepseek_block", kind="block", arch=DEEPSEEK),
        dict(name="rowwise_block", kind="block", arch=JAMBA, dispatch="rowwise"),
        dict(name="ckpt", kind="ckpt", arch=DENSE),
        dict(name="serve", kind="serve", arch=JAMBA),
        *_pp_cases("2"),
    ]),
    "4": dict(shape=[2, 2, 1], axes=["pod", "data", "model"], cases=[
        dict(name="dense_pod", kind="train", arch=DENSE),
        *_pp_cases("4"),
    ]),
}
TWO_ROWS = AbstractMesh((2, 1), ("data", "model"))

# the JAX package's train on a (data 2, model 1) mesh of 2 host devices,
# rowwise dispatch (the device count is fixed before JAX starts)
REF_MESH = textwrap.dedent("""
    import dataclasses, json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax
    import numpy as np
    from jax.sharding import Mesh
    from repro import configs
    from repro.launch import train
    from repro.optim import AdamW
    assert len(jax.devices()) == 2
    mesh = Mesh(np.array(jax.devices()).reshape(2, 1), ("data", "model"))
    cfg = configs.get_reduced(sys.argv[1])
    cfg = dataclasses.replace(cfg, moe=cfg.moe._replace(dispatch="rowwise"))
    rep = train.train(cfg, steps=int(sys.argv[2]), global_batch=int(sys.argv[3]),
                      seq_len=int(sys.argv[4]), mesh=mesh, log_every=1000,
                      opt=AdamW(peak_lr=1e-3, warmup_steps=1, total_steps=6))
    print(json.dumps(rep["losses"]))
""")


def _jopt():
    return JAdamW(peak_lr=1e-3, warmup_steps=1, total_steps=6)


def _ref_params(arch):
    """The JAX package's initial parameters (``train``'s: seed 0, jitted) as
    the port's state dict."""
    init = jax.jit(functools.partial(JM.init_params, cfg=jconfigs.get_reduced(arch)))
    jp = init(jax.random.PRNGKey(0))
    return lm_params_from_reference(jax.tree.map(np.asarray, jp), configs.get_reduced(arch))


def _ref_train(arch):
    """The JAX package's ``train`` on one host device: its losses."""
    rep = jtrain.train(jconfigs.get_reduced(arch), steps=R.STEPS, global_batch=R.BATCH,
                       seq_len=R.SEQ, opt=_jopt(), log_every=1000)
    return rep["losses"]


def _env():
    return dict(os.environ, PYTHONPATH=SRC + os.pathsep + HERE + os.pathsep
                + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")


def _skewed_ids(cfg, seed=0):
    """Expert ids for every MoE block of ``cfg`` over step 0's tokens, 70% of
    the first choices on expert 0, so that the global plan drops pairs
    (random weights route the reduced model's 64 tokens too evenly to fill
    an expert's capacity)."""
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    rng = np.random.default_rng(seed)
    T = R.BATCH * R.SEQ
    out = []
    for _ in range(cfg.n_periods * cfg.period.count("moe")):
        first = rng.choice(E, size=T, p=[0.7] + [0.3 / (E - 1)] * (E - 1))
        rest = [(first + 1 + j + rng.integers(0, E - k + 1, size=T)) % E for j in range(k - 1)]
        out.append(torch.from_numpy(np.stack([first, *rest], axis=1)).long())
    return out


def _one_device_keeps(cfg, params, ids):
    """A one-device forward of step 0's batch with the routes ``ids``: the
    kept-pair masks of every MoE block."""
    model = Transformer.from_params(cfg, params, device="cpu")
    toks = lm_data.global_batch_at(R.pipe(cfg), 0)[:, :-1]
    with R.Keeps(replay=ids) as k, torch.no_grad():
        model(torch.from_numpy(toks).long())
    return k.keeps


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """This module's one-device runs on one thread: the rank processes (and
    the other test workers) have the other cores, and the reduced models'
    small ops only wait for threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawn both worlds once; with them, the one-device runs to compare."""
    work = str(tmp_path_factory.mktemp("train_mesh"))
    ref_mesh = subprocess.Popen([sys.executable, "-c", REF_MESH, JAMBA, str(R.STEPS),
                                 str(R.BATCH), str(R.SEQ)], env=_env(), stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
    params = {arch: _ref_params(arch) for arch in (DENSE, DEEPSEEK, JAMBA)}
    for arch, p in params.items():
        np.savez(os.path.join(work, f"{arch}.npz"), **{k: v.numpy() for k, v in p.items()})
    ids = _skewed_ids(configs.get_reduced(JAMBA))
    keeps = _one_device_keeps(configs.get_reduced(JAMBA), params[JAMBA], ids)
    torch.save(ids, os.path.join(work, "jamba_keeps_ids.pt"))
    # a one-device checkpoint at step 2, for the ranks to resume
    train_mod.train(configs.get_reduced(DENSE), steps=2, global_batch=R.BATCH, seq_len=R.SEQ,
                    ckpt_dir=os.path.join(work, "ck1"), ckpt_every=2, opt=R.optimizer(),
                    params=params[DENSE], device="cpu")
    with open(os.path.join(work, "cases.json"), "w") as f:
        json.dump(CASES, f)
    procs = {w: [subprocess.Popen([sys.executable, os.path.join(HERE, "_torch_train_mesh_ranks.py"),
                                   str(r), w, work], env=_env(), stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True) for r in range(int(w))]
             for w in CASES}
    try:
        one = {name: R.run_steps(R.config(case), params[case["arch"]], None, R.optimizer(case))
               for name, case in (("dense", CASES["2"]["cases"][0]),
                                  ("deepseek", CASES["2"]["cases"][1]),
                                  ("jamba", CASES["2"]["cases"][2]))}
        ref = {"dense": _ref_train(DENSE), "deepseek": _ref_train(DEEPSEEK)}
        outs, errs = [], []
        for p in [*procs["2"], *procs["4"], ref_mesh]:
            out, err = p.communicate(timeout=RANK_TIMEOUT_S)
            outs.append(out)
            if p.returncode:
                errs.append(err[-3000:])
        assert not errs, errs
        ref["rowwise_mesh"] = json.loads(outs[-1].strip().splitlines()[-1])
    finally:
        for p in [*procs["2"], *procs["4"], ref_mesh]:
            if p.poll() is None:
                p.kill()
                p.wait()
    got = {w: [torch.load(os.path.join(work, f"world{w}_rank{r}.pt"), weights_only=False)
               for r in range(int(w))] for w in CASES}
    return dict(work=work, params=params, got=got, one=one, ref=ref, one_keeps=keeps)


def _same_on_every_rank(results, name):
    first = results[0][name]
    for other in results[1:]:
        assert other[name]["losses"] == first["losses"]
        assert set(other[name]["state"]) == set(first["state"])
        for k, v in first["state"].items():
            assert v.tobytes() == other[name]["state"][k].tobytes(), k


def _state_close(got, want, lr):
    """The rule of ``tests/test_torch_train.py``: every entry within 3 lr
    for the parameters, all but 0.1% of the entries within STATE_TOL."""
    off = total = 0
    for k, w in want.items():
        g = got[k]
        if k.startswith("params/"):
            assert np.abs(g - w).max() <= 3 * lr, k
        off += int(np.sum(np.abs(g - w) > STATE_TOL["atol"] + STATE_TOL["rtol"] * np.abs(w)))
        total += w.size
    assert off <= 1e-3 * total, (off, total)


@pytest.mark.parametrize("name", ["dense", "deepseek", "jamba"])
def test_two_ranks_train_like_one_device(ranks, name):
    """Both ranks' losses and gathered states bit-equal; the losses within
    PORT_TOL of the port's one-device run, the state by the Adam rule."""
    got = ranks["got"]["2"]
    _same_on_every_rank(got, name)
    np.testing.assert_allclose(got[0][name]["losses"], ranks["one"][name]["losses"], **PORT_TOL)
    _state_close(got[0][name]["state"], ranks["one"][name]["state"], R.optimizer().peak_lr)


@pytest.mark.parametrize("name", ["dense", "deepseek"])
def test_two_ranks_match_reference_train(ranks, name):
    """The dense and the MoE case against the JAX package's ``train`` on one
    host device, from the same parameters and batches."""
    np.testing.assert_allclose(ranks["got"]["2"][0][name]["losses"], ranks["ref"][name],
                               **REF_TOL)


def test_rowwise_two_ranks_equal_one_device_under_two_rows(ranks):
    """``get_optimized``'s rowwise dispatch on two ranks: a rank's tokens are
    one row of the reference's plan, so the run equals a one-device run
    under ``hints.use_mesh(AbstractMesh((2, 1), ...))`` and the JAX
    package's ``train`` on a 2-device host mesh."""
    got = ranks["got"]["2"]
    _same_on_every_rank(got, "rowwise")
    cfg = R.config(dict(arch=JAMBA, dispatch="rowwise"))
    model = Transformer.from_params(cfg, ranks["params"][JAMBA], device="cpu")
    opt = R.optimizer()
    st = opt.init(dict(model.named_parameters()))
    step = make_train_step(opt)
    losses = []
    with hints.use_mesh(TWO_ROWS):
        for i in range(R.STEPS):
            toks = torch.from_numpy(lm_data.global_batch_at(R.pipe(cfg), i)).long()
            loss, st = step(model, st, {"tokens": toks})
            losses.append(float(loss))
    np.testing.assert_allclose(got[0]["rowwise"]["losses"], losses, **PORT_TOL)
    np.testing.assert_allclose(got[0]["rowwise"]["losses"], ranks["ref"]["rowwise_mesh"],
                               **REF_TOL)


def test_pod_axis_replicates_and_averages(ranks):
    """A (pod 2, data 2, model 1) world: the leaves cut over data only,
    gradients reduce-scattered over data and all_reduced over pod; the four
    ranks agree bit for bit and with the one-device run."""
    got = ranks["got"]["4"]
    _same_on_every_rank(got, "dense_pod")
    np.testing.assert_allclose(got[0]["dense_pod"]["losses"], ranks["one"]["dense"]["losses"],
                               **PORT_TOL)
    _state_close(got[0]["dense_pod"]["state"], ranks["one"]["dense"]["state"],
                 R.optimizer().peak_lr)


@pytest.mark.parametrize("name", ["dense", "deepseek", "jamba", "rowwise", "dense_pod"])
def test_collectives_issued_equal_the_plan(ranks, name):
    """Every collective the ranks issued, counted by the transport, equals
    ``plan.collective_bytes()`` (per step, times the steps); the driver's
    own run issues the same."""
    w = "4" if name == "dense_pod" else "2"
    for r in ranks["got"][w]:
        res = r[name]
        assert res["issued"] == res["want"]
        assert res["want"]["all-reduce"] > 0
        if "driver" in res:
            assert res["driver"]["losses"] == res["losses"]
            assert res["driver"]["issued"] == res["want"]
    assert ranks["got"]["2"][0]["dense"]["want"]["all-gather"] > 0
    assert ranks["got"]["2"][0]["jamba"]["want"]["all-gather"] > 0  # the global plan's counts


@pytest.mark.parametrize("config, remat, mesh", PER_PERIOD,
                         ids=[f"{c}-{r}-{m}" for c, r, m in PER_PERIOD])
def test_per_period_step_equals_whole_gather_step(ranks, config, remat, mesh):
    """Each period's sharded leaves gathered inside it (again in its remat
    recompute) and their gradients reduce-scattered as its backward ends:
    on every rank the losses, parameters and moments after three steps
    equal, bit for bit, those of the step that gathers every leaf for the
    whole step (built from the plan's ``compute`` / ``sync_grads`` /
    ``cut``); the collectives issued are the per-period plan's; the full
    bytes held at once stay within ``held_bound`` (the leaves outside the
    periods and one period, weights and gradients; every period's weights
    with remat off), which the whole-gather step's reading exceeds."""
    for r in ranks["got"][_world(mesh)]:
        R.check_per_period(r[f"pp/{config}/{remat}/{mesh}"])


def test_per_period_gathers_twice_under_remat(ranks):
    """Over data a period's leaf is gathered by its forward and again by its
    remat recompute (``dots`` too), once with remat off; the gradients'
    reduce-scatter is the same under all three."""
    runs = {r: ranks["got"]["2"][0][f"pp/dense/{r}/2x1"]["pp"]["issued"]
            for r in ("full", "dots", "off")}
    assert runs["full"] == runs["dots"]
    assert runs["full"]["reduce-scatter"] == runs["off"]["reduce-scatter"] > 0
    assert runs["off"]["all-gather"] < runs["full"]["all-gather"] < 2 * runs["off"]["all-gather"]


def test_global_dispatch_keeps_the_one_device_pairs(ranks):
    """Jamba's ``dispatch="global"`` at capacity factor 1.25 over two ranks,
    the same skewed routes replayed in both runs: each rank's kept-pair
    masks, laid end to end, equal the one-device plan's (which drops
    pairs)."""
    one = ranks["one_keeps"]
    parts = [r["jamba_keeps"]["keeps"] for r in ranks["got"]["2"]]
    assert len(one) == len(parts[0]) == len(parts[1]) > 0
    for layer, keep in enumerate(one):
        assert torch.equal(torch.cat([p[layer] for p in parts]), keep), layer
    assert not all(bool(k.all()) for k in one)


def test_global_aux_loss_and_gradient_equal_one_device(ranks):
    """Hazard (b): the aux loss on two ranks is the one-device (global) aux,
    and the ranks' gradients of it, averaged as the drivers average them,
    are the one-device gradient."""
    cfg = configs.get_reduced(DEEPSEEK)
    blk = R.moe_block(cfg, ranks["params"][DEEPSEEK])
    y, aux, grads = R.moe_aux_and_grads(blk, R.moe_block_input(cfg))
    for r in ranks["got"]["2"]:
        res = r["deepseek_block"]
        lo, n = res["rows"]
        torch.testing.assert_close(res["aux"], aux, rtol=1e-6, atol=0)
        torch.testing.assert_close(res["out"], y[lo:lo + n], rtol=1e-5, atol=1e-6)
        for g, want in zip(res["grads"], grads):
            torch.testing.assert_close(g, want, rtol=1e-5, atol=1e-7)


def test_rank_is_one_row_of_the_reference_plan(ranks):
    """Hazard (a): under the (2, 1) mesh a rank's tokens are one row of the
    rowwise plan at ``capacity(T_all / 2)``; its MoE output and aux equal
    the one-device rowwise block's under two abstract rows."""
    cfg = R.config(dict(arch=JAMBA, dispatch="rowwise"))
    blk = R.moe_block(cfg, ranks["params"][JAMBA])
    with hints.use_mesh(TWO_ROWS):
        y, aux, grads = R.moe_aux_and_grads(blk, R.moe_block_input(cfg))
    T_all = R.BATCH * R.SEQ
    for r in ranks["got"]["2"]:
        res = r["rowwise_block"]
        lo, n = res["rows"]
        assert res["layout"] == (1, moe.capacity(T_all // 2, cfg.moe), False)
        torch.testing.assert_close(res["out"], y[lo:lo + n], rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(res["aux"], aux, rtol=1e-6, atol=0)
        for g, want in zip(res["grads"], grads):
            torch.testing.assert_close(g, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("ranks_t, dims_kw, want", [
    # rowwise: each of 2 ranks holds one of the 2 rows (capacity of 32 tokens)
    (2, dict(dispatch="rowwise"), (1, 24, False)),
    # one device under the same mesh: 2 rows of its own
    (1, dict(dispatch="rowwise"), (2, 24, False)),
    # the global dispatch: one row over both ranks, capacity of all 64 tokens
    (2, dict(), (1, 40, True)),
    # dropless: every pair kept, planned locally
    (2, dict(capacity_factor=0.0), (1, 32, False)),
], ids=["rowwise-2-ranks", "rowwise-1-device", "global-2-ranks", "dropless-2-ranks"])
def test_moe_layout_of_a_rank(ranks_t, dims_kw, want):
    """:func:`moe.layout` for 32 tokens a rank (64 on one device) of 4
    experts top 2 under a (2, 1) mesh."""
    dims = moe.MoEDims(num_experts=4, top_k=2, d_ff=8, **dims_kw)
    T = 64 // ranks_t
    with hints.use_mesh(TWO_ROWS):
        assert tuple(moe.layout(T, dims, ranks_t)) == want


def test_checkpoints_resume_across_worlds(ranks, tmp_path):
    """4 steps checkpointed every 2, then a resume for 2 more, equal 6
    steps uninterrupted (bit for bit, on both ranks); the 2-rank checkpoint
    (one-device format) resumed on one device and a one-device checkpoint
    resumed on 2 ranks continue within PORT_TOL."""
    got = ranks["got"]["2"]
    for r in got:
        c = r["ckpt"]
        assert c["final_step"] == 6 and c["first"] + c["resumed"] == c["whole"]
        assert c["from_one_step"] == 4
        assert c == got[0]["ckpt"]
    cfg = configs.get_reduced(DENSE)
    kw = dict(global_batch=R.BATCH, seq_len=R.SEQ, opt=R.optimizer(),
              params=ranks["params"][DENSE], device="cpu")
    d = str(tmp_path / "ck")
    shutil.copytree(os.path.join(ranks["work"], "ck2"), d)
    shutil.rmtree(os.path.join(d, "step_00000006"))  # resume the 2-rank step 4
    one = train_mod.train(cfg, steps=2, ckpt_dir=d, ckpt_every=2, **kw)
    np.testing.assert_allclose(one["losses"], got[0]["ckpt"]["resumed"], **PORT_TOL)
    whole = train_mod.train(cfg, steps=4, **kw)
    np.testing.assert_allclose(got[0]["ckpt"]["from_one"], whole["losses"][2:], **PORT_TOL)


def test_serve_over_two_ranks(ranks):
    """``serve(mesh=)`` of Jamba (global dispatch at capacity factor 1.25 in
    prefill and decode): each rank serves its two rows and returns the whole
    batch's tokens, those of a one-device ``serve``, and its rows' prefill
    logits, those of the same rows (by their index in the batch) on one
    device."""
    cfg = configs.get_reduced(JAMBA)
    one = serve_mod.serve(cfg, params=ranks["params"][JAMBA], device="cpu", **R.SERVE)
    n = R.BATCH // 2
    for rank, r in enumerate(ranks["got"]["2"]):
        np.testing.assert_array_equal(r["serve"]["generated"], one["generated"])
        np.testing.assert_allclose(r["serve"]["logits"].numpy(),
                                   one["prefill_logits"][rank * n:(rank + 1) * n].numpy(),
                                   **PORT_TOL)


# ---------------------------------------------------------------------------
# Without processes
# ---------------------------------------------------------------------------


def test_remat_recompute_keeps_the_mesh():
    """The backward of CUDA ops, and with it a remat recompute, runs on
    autograd's device thread, which does not see the forward's context: the
    recompute re-enters the forward's mesh and token split.  Held on the
    CPU by taking the gradients outside the ``use_mesh`` block the loss was
    formed in (the rowwise plan would otherwise recompute one row at
    another capacity): the gradients taken inside it, bit for bit."""
    cfg = R.config(dict(arch=DEEPSEEK, dispatch="rowwise"))
    model = Transformer(cfg, device="cpu", seed=0)
    batch = {"tokens": torch.from_numpy(lm_data.global_batch_at(R.pipe(cfg), 0)).long()}
    params = list(model.parameters())
    with hints.use_mesh(TWO_ROWS):
        inside = torch.autograd.grad(M.loss_fn(model, batch), params)
        loss = M.loss_fn(model, batch)
    outside = torch.autograd.grad(loss, params)
    assert all(torch.equal(a, b) for a, b in zip(inside, outside))

LAYOUTS = {"data2": AbstractMesh((2, 1), ("data", "model")),
           "pod2xdata2": AbstractMesh((2, 2, 1), ("pod", "data", "model"))}


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("arch", sorted(configs.ARCHS))
def test_plan_follows_param_and_state_specs(arch, layout):
    """Every reduced architecture: a leaf is sharded exactly where its spec
    and its moments' spec cut a dimension over ``data`` (after the
    divisibility fix), its block that dimension / data; int8 moments
    replicate every leaf; the at-rest bytes are the blocks' and the
    moments'."""
    cfg, mesh = configs.get_reduced(arch), LAYOUTS[layout]
    params = dict(M.abstract_params(cfg).named_parameters())
    for quantize in (False, True):
        opt = AdamW(quantize_states=quantize)
        plan = DataParallelPlan(cfg, params, mesh, opt)
        pspecs = M.param_specs(cfg, params, mesh)
        mu = opt.state_specs(pspecs).mu
        assert plan.world == (4 if layout == "pod2xdata2" else 2) and plan.shards == 2
        cut = {}
        for k, p in params.items():
            dim = plan.leaves[k].dim
            data_dims = [i for i, e in enumerate(pspecs[k]) if e == "data"]
            if quantize or mu[k] != pspecs[k] or not data_dims:
                assert dim is None, k
            else:
                assert [dim] == data_dims and p.shape[dim] % 2 == 0, k
            cut[k] = plan.cut(k, p)
            want = list(p.shape)
            if dim is not None:
                want[dim] //= 2
            assert list(cut[k].shape) == want, k
        assert any(plan.leaves[k].dim is not None for k in params) != quantize
        st = opt.init(cut)
        moments = [t for tree in (st.mu, st.nu) for v in tree.values()
                   for t in (v if isinstance(v, tuple) else (v,))]
        held = sum(t.numel() * t.element_size() for t in [*cut.values(), *moments])
        assert plan.at_rest_bytes() == held


class _FakeMesh:
    """One rank's view of a (data 2, model 1) DeviceMesh, without processes."""

    mesh_dim_names = ("data", "model")
    shape = (2, 1)

    def __init__(self, index):
        self.index = index

    def size(self):
        return 2

    def get_coordinate(self):
        return (self.index, 0)

    def get_group(self, axis):
        return None


def test_batch_for_mesh_rows():
    """Each rank's rows of ``batch_for_mesh``, laid end to end, are
    ``global_batch_at`` and the JAX package's ``batch_for_mesh`` gathered to
    numpy; a batch the ranks do not divide raises."""
    cfg = lm_data.PipelineConfig(vocab_size=97, seq_len=9, global_batch=6, seed=3)
    jcfg = jlm.PipelineConfig(vocab_size=97, seq_len=9, global_batch=6, seed=3)
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    for step in (0, 5):
        rows = [lm_data.batch_for_mesh(cfg, step, _FakeMesh(i), device="cpu") for i in (0, 1)]
        assert all(r.shape == (3, 9) and r.dtype == torch.long for r in rows)
        whole = torch.cat(rows).numpy()
        np.testing.assert_array_equal(whole, lm_data.global_batch_at(cfg, step))
        np.testing.assert_array_equal(whole, np.asarray(jlm.batch_for_mesh(jcfg, step, jmesh)))
        np.testing.assert_array_equal(lm_data.batch_for_mesh(cfg, step, None, device="cpu"),
                                      whole)
    with pytest.raises(ValueError, match="does not split"):
        lm_data.batch_for_mesh(dataclasses.replace(cfg, global_batch=5), 0, _FakeMesh(0),
                               device="cpu")
