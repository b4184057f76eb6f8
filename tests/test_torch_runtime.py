"""The port's optimizer, token pipeline, fault-tolerant loop and training
driver (``repro_torch.optim``, ``data.lm``, ``runtime``, ``launch.train``)
on the CPU.

Each of ``tests/test_runtime.py``'s cases runs on the port, and the port is
held against the JAX package from the same inputs:

* ``warmup_cosine`` within rtol 1e-6 (both compute in fp32; the two
  libraries' ``cos`` differ by an ulp or two);
* ``AdamW`` (fp32 and 8-bit moments, with and without clipping): parameters
  and moments within rtol 1e-5 / atol 2e-5 after six steps (the global norm
  is summed over the leaves in another order; the update is op for op the
  reference's), and the int8 codes equal except at most 0.1% of them off by
  one at rounding ties (the scales move by an ulp when the clip scale does);
* gradient compression: the same codes and scales, residuals within 1e-6;
* the token pipeline: bit for bit, for several ``(seed, step)`` and row
  splits.
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import lm as jlm
from repro.optim import AdamW as JAdamW
from repro.optim import adamw as jadamw
from repro_torch import configs
from repro_torch.checkpoint import store
from repro_torch.data import lm as lm_data
from repro_torch.launch import train as train_mod
from repro_torch.optim import (AdamW, compress_grads, decompress_grads, init_residuals,
                               warmup_cosine)
from repro_torch.optim import adamw
from repro_torch.runtime import StepFailure, TrainLoop, TrainLoopConfig, reshard_tree

OPT_RTOL, OPT_ATOL = 1e-5, 2e-5
CODE_TIES = 1e-3  # share of int8 codes that may differ, each by one

# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


def test_warmup_cosine_shape():
    lr0 = warmup_cosine(0, peak_lr=1.0, warmup_steps=10, total_steps=100)
    lrw = warmup_cosine(10, peak_lr=1.0, warmup_steps=10, total_steps=100)
    lre = warmup_cosine(100, peak_lr=1.0, warmup_steps=10, total_steps=100)
    assert lr0 == 0.0 and abs(lrw - 1.0) < 1e-6 and lre == pytest.approx(0.1, rel=1e-3)


def test_warmup_cosine_matches_reference():
    for kw in (dict(peak_lr=3e-4, warmup_steps=10, total_steps=100),
               dict(peak_lr=1e-3, warmup_steps=0, total_steps=7, final_frac=0.0),
               dict(peak_lr=1.0, warmup_steps=5, total_steps=5)):
        for step in range(0, kw["total_steps"] + 3):
            assert warmup_cosine(step, **kw) == pytest.approx(
                float(jadamw.warmup_cosine(step, **kw)), rel=1e-6, abs=0.0)


def _opt_problem(seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"w": (64, 48), "b": (37,), "e": (300, 16)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    # gradients spanning six decades, as a model's do
    grads = [{k: (rng.standard_normal(s) * 10 ** rng.uniform(-6, 0, s)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(6)]
    return params, grads


def _codes_close(got, want):
    got, want = got.numpy().astype(int), np.asarray(want).astype(int)
    off = np.abs(got - want)
    assert off.max() <= 1 and np.mean(off > 0) <= CODE_TIES


@pytest.mark.parametrize("clip", [1.0, None], ids=["clip", "no-clip"])
@pytest.mark.parametrize("quantize", [False, True], ids=["fp32", "int8"])
def test_adamw_matches_reference(quantize, clip):
    params, grads = _opt_problem()
    kw = dict(peak_lr=1e-2, warmup_steps=2, total_steps=6, clip_norm=clip,
              quantize_states=quantize)
    jopt, opt = JAdamW(**kw), AdamW(**kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jst = jopt.init(jp)
    p = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    st = opt.init(p)
    for g in grads:
        jp, jst = jopt.update(jp, {k: jnp.asarray(v) for k, v in g.items()}, jst)
        p, st = opt.update(p, {k: torch.from_numpy(v) for k, v in g.items()}, st)
    assert st.step == int(jst.step) == 6
    for k in params:
        np.testing.assert_allclose(p[k].numpy(), np.asarray(jp[k]), rtol=OPT_RTOL,
                                   atol=OPT_ATOL)
        for mine, theirs in ((st.mu[k], jst.mu[k]), (st.nu[k], jst.nu[k])):
            if quantize:
                _codes_close(mine[0], theirs[0])
                np.testing.assert_allclose(mine[1].numpy(), np.asarray(theirs[1]),
                                           rtol=OPT_RTOL, atol=1e-9)
            else:
                np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), rtol=OPT_RTOL,
                                           atol=1e-8)


def test_adamw_bf16_params_updated_in_fp32():
    """A bf16 parameter is updated in fp32 and cast back, with no master
    copy: the reference's arithmetic on the same bf16 values."""
    params, grads = _opt_problem(1)
    opt = AdamW(peak_lr=1e-2, warmup_steps=1, total_steps=6)
    jopt = JAdamW(peak_lr=1e-2, warmup_steps=1, total_steps=6)
    p = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in params.items()}
    jp = {k: jnp.asarray(v.float().numpy()).astype(jnp.bfloat16) for k, v in p.items()}
    st, jst = opt.init(p), jopt.init(jp)
    assert set(st.mu) == set(p) and all(m.dtype == torch.float32 for m in st.mu.values())
    for g in grads[:3]:
        gb = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in g.items()}
        p, st = opt.update(p, gb, st)
        jp, jst = jopt.update(jp, {k: jnp.asarray(v.float().numpy()).astype(jnp.bfloat16)
                                   for k, v in gb.items()}, jst)
    for k in params:
        assert p[k].dtype == torch.bfloat16
        got = p[k].float().numpy()
        want = np.asarray(jp[k].astype(jnp.float32))
        # one bf16 ulp (2^-8 relative) where the fp32 values straddle a rounding
        np.testing.assert_allclose(got, want, rtol=2 ** -8, atol=1e-6)
        assert np.mean(got != want) <= 0.01


def test_adamw_quantized_matches_fp32():
    """``tests/test_runtime.py::test_adamw_quantized_matches_fp32`` on the port."""
    rng = np.random.default_rng(0)
    w0 = torch.from_numpy(rng.standard_normal((32, 32)).astype(np.float32))
    X = torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32))
    traces = []
    for quant in [False, True]:
        opt = AdamW(peak_lr=1e-2, warmup_steps=1, total_steps=50, clip_norm=1.0,
                    quantize_states=quant)
        p = {"w": w0.clone().requires_grad_(True)}
        st = opt.init(p)
        ls = []
        for _ in range(20):
            loss = torch.mean((X @ p["w"] - y) ** 2)
            (g,) = torch.autograd.grad(loss, [p["w"]])
            p, st = opt.update(p, {"w": g}, st)
            ls.append(float(loss.detach()))
        traces.append(ls)
    assert traces[0][-1] < traces[0][0]
    assert abs(traces[1][-1] - traces[0][-1]) < 0.1 * abs(traces[0][0])


def test_grad_clipping_bounds_update():
    opt = AdamW(peak_lr=1.0, warmup_steps=0, total_steps=10, clip_norm=1e-3,
                weight_decay=0.0)
    params = {"w": torch.zeros(4)}
    st = opt.init(params)
    p2, _ = opt.update(params, {"w": torch.full((4,), 1e9)}, st)
    assert float(torch.max(torch.abs(p2["w"]))) < 10.0


def test_grad_compression_error_feedback():
    """``tests/test_runtime.py::test_grad_compression_error_feedback`` on the
    port, and the reference's codes, scales and residuals."""
    rng = np.random.default_rng(0)
    g_np = rng.standard_normal((64,)).astype(np.float32)
    g = {"w": torch.from_numpy(g_np)}
    res = init_residuals(g)
    qs, res = compress_grads(g, res)
    back = decompress_grads(qs, g)
    err = np.abs(back["w"].numpy() - g_np)
    assert err.max() <= np.abs(g_np).max() / 127 + 1e-6
    np.testing.assert_allclose(res["w"].numpy(), g_np - back["w"].numpy(), atol=1e-6)
    jqs, jres = jadamw.compress_grads({"w": jnp.asarray(g_np)},
                                      jadamw.init_residuals({"w": jnp.asarray(g_np)}))
    assert np.array_equal(qs["w"][0].numpy(), np.asarray(jqs["w"][0]))
    assert np.array_equal(qs["w"][1].numpy(), np.asarray(jqs["w"][1]))
    np.testing.assert_allclose(res["w"].numpy(), np.asarray(jres["w"]), atol=1e-6)
    # a second round feeds the residual back in
    qs2, res2 = compress_grads(g, res)
    jqs2, jres2 = jadamw.compress_grads({"w": jnp.asarray(g_np)}, jres)
    _codes_close(qs2["w"][0], jqs2["w"][0])
    np.testing.assert_allclose(res2["w"].numpy(), np.asarray(jres2["w"]), atol=1e-6)


def test_quantize_matches_reference():
    """Block-wise int8 codes and scales of ragged lengths, bit for bit."""
    rng = np.random.default_rng(5)
    for n in (1, 255, 256, 1000, 100_000):
        x = (rng.standard_normal(n) * 10 ** rng.uniform(-5, 2, n)).astype(np.float32)
        q, s = adamw._quantize(torch.from_numpy(x))
        jq, js = jadamw._quantize(jnp.asarray(x))
        assert np.array_equal(q.numpy(), np.asarray(jq)) and np.array_equal(s.numpy(),
                                                                          np.asarray(js))
        back = adamw._dequantize(q, s, (n,))
        assert np.array_equal(back.numpy(), np.asarray(jadamw._dequantize(jq, js, (n,))))


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------


def test_lm_pipeline_determinism_and_sharding():
    cfg = lm_data.PipelineConfig(vocab_size=512, seq_len=32, global_batch=8, seed=3)
    a = lm_data.global_batch_at(cfg, 5)
    np.testing.assert_array_equal(a, lm_data.global_batch_at(cfg, 5))
    parts = np.concatenate([lm_data.host_batch_at(cfg, 5, 0, 2),
                            lm_data.host_batch_at(cfg, 5, 2, 4),
                            lm_data.host_batch_at(cfg, 5, 6, 2)])
    np.testing.assert_array_equal(a, parts)
    assert not (a == lm_data.global_batch_at(cfg, 6)).all()
    assert a.min() >= 0 and a.max() < 512


@pytest.mark.parametrize("seed,vocab", [(0, 256), (3, 512), (7, 151_936)])
def test_tokens_bit_equal_reference(seed, vocab):
    cfg = lm_data.PipelineConfig(vocab_size=vocab, seq_len=33, global_batch=4, seed=seed)
    jcfg = jlm.PipelineConfig(vocab_size=vocab, seq_len=33, global_batch=4, seed=seed)
    for step in (0, 1, 17, 1000):
        got = lm_data.global_batch_at(cfg, step)
        assert got.dtype == np.int32
        assert np.array_equal(got, jlm.global_batch_at(jcfg, step))
        assert np.array_equal(lm_data.host_batch_at(cfg, step, 1, 2),
                              jlm.host_batch_at(jcfg, step, 1, 2))
    t = lm_data.batch_for_device(cfg, 17, "cpu")
    assert t.dtype == torch.long and np.array_equal(t.numpy(), jlm.global_batch_at(jcfg, 17))
    inputs, labels = lm_data.targets_from_tokens(t)
    assert torch.equal(inputs, t[:, :-1]) and torch.equal(labels, t[:, 1:])
    assert lm_data.PipelineState.from_dict(lm_data.PipelineState(step=9).to_dict()).step == 9


def test_frame_embeddings_unit_rms():
    x = lm_data.frame_embeddings(64, 16, 2, seed=0, device="cpu").numpy()
    np.testing.assert_allclose(np.sqrt((x * x).mean(-1)), 1.0, atol=0.05)
    want = np.asarray(jlm.frame_embeddings(64, 16, 2, seed=0, step=3))
    assert np.array_equal(lm_data.frame_embeddings(64, 16, 2, seed=0, step=3,
                                                   device="cpu").numpy(), want)


def test_pipeline_device_rule(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = lm_data.PipelineConfig(vocab_size=64, seq_len=8, global_batch=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm_data.batch_for_device(cfg, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm_data.frame_embeddings(8, 4, 1)


# ---------------------------------------------------------------------------
# fault-tolerant loop
# ---------------------------------------------------------------------------


def test_trainloop_failure_injection_and_resume(tmp_path):
    fails = {3: 1, 7: 5}  # step 7 exhausts retries -> restore path
    counts = {}

    def injector(step):
        if counts.get(step, 0) < fails.get(step, 0):
            counts[step] = counts.get(step, 0) + 1
            raise StepFailure(f"injected@{step}")

    def step_fn(state, batch):
        return {"w": state["w"] + batch}, {"w": float(state["w"])}

    loop = TrainLoop(
        TrainLoopConfig(ckpt_dir=str(tmp_path), ckpt_every=2, max_retries_per_step=2),
        step_fn, lambda s: torch.tensor(1.0), {"w": torch.zeros(())}, injector,
    )
    out = loop.run(10)
    assert out["final_step"] == 10
    assert out["restarts"] >= 4
    assert float(loop.state["w"]) == 10.0  # semantics preserved across restart
    assert torch.is_tensor(loop.state["w"])  # the restore put it back as a tensor


def test_trainloop_straggler_detection(tmp_path):
    def step_fn(state, batch):
        if batch == 5:
            time.sleep(0.3)
        return state, {}

    loop = TrainLoop(
        TrainLoopConfig(ckpt_dir=str(tmp_path), ckpt_every=100, straggler_factor=5.0),
        step_fn, lambda s: s, {"w": torch.zeros(())},
    )
    loop.run(8)
    assert any(e["step"] == 5 for e in loop.straggler_events)


def test_trainloop_resume_skips_corrupt_head(tmp_path):
    """Resume lands on the newest step that verifies; ``shardings`` places the
    restored leaves (one device for all here) and numpy stays numpy only
    where the state holds no tensor."""
    from repro_torch.resilience.integrity import flip_bit

    d = str(tmp_path)
    state = {"w": torch.zeros(3), "n": 0}
    for step in (2, 4):
        store.save(d, step, {"w": torch.full((3,), float(step)), "n": step})
    flip_bit(str(tmp_path / "step_00000004" / "leaf_00001.npy"), 200)
    loop = TrainLoop(TrainLoopConfig(ckpt_dir=d), lambda s, b: (s, {}), lambda s: None, state)
    assert loop.try_resume()
    assert loop.step == 2 and loop.integrity_fallbacks == 1
    assert torch.equal(loop.state["w"], torch.full((3,), 2.0)) and int(loop.state["n"]) == 2
    loop2 = TrainLoop(TrainLoopConfig(ckpt_dir=d), lambda s, b: (s, {}), lambda s: None,
                      state)
    assert loop2.try_resume(shardings="cpu") and torch.is_tensor(loop2.state["n"])
    empty = TrainLoop(TrainLoopConfig(ckpt_dir=str(tmp_path / "none")), lambda s, b: (s, {}),
                      lambda s: None, state)
    assert not empty.try_resume()


def test_reshard_tree_places_leaves():
    tree = {"a": np.ones((2, 2), np.float32), "b": (torch.zeros(3), np.int64(4))}
    out = reshard_tree(tree, "cpu")
    assert torch.is_tensor(out["a"]) and torch.is_tensor(out["b"][1])
    assert torch.equal(out["a"], torch.ones(2, 2)) and int(out["b"][1]) == 4
    assert reshard_tree(tree, None) is tree


# ---------------------------------------------------------------------------
# the training driver
# ---------------------------------------------------------------------------


def test_train_driver_reduced_config(tmp_path):
    """``tests/test_launch.py::test_train_driver_reduced_config`` on the port."""
    cfg = configs.get_reduced("phi4-mini-3.8b")
    opt = AdamW(peak_lr=1e-3, warmup_steps=5, total_steps=20)
    report = train_mod.train(cfg, steps=20, global_batch=2, seq_len=32,
                             ckpt_dir=str(tmp_path / "ck"), ckpt_every=10, opt=opt,
                             device="cpu")
    assert len(report["losses"]) == 20 and np.isfinite(report["losses"]).all()
    assert len(report["step_seconds"]) == 20
    assert store.latest_step(str(tmp_path / "ck")) == 20


def test_train_driver_resume(tmp_path):
    """``tests/test_launch.py::test_train_driver_resume`` on the port; the
    resumed run's losses equal an uninterrupted run's steps 11-15 (on the
    CPU the sums are deterministic: bit for bit)."""
    cfg = configs.get_reduced("qwen3-8b")
    opt = AdamW(peak_lr=1e-3, warmup_steps=2, total_steps=20)
    d = str(tmp_path / "ck")
    train_mod.train(cfg, steps=10, global_batch=2, seq_len=16, ckpt_dir=d, ckpt_every=5,
                    opt=opt, device="cpu")
    assert store.latest_step(d) == 10
    report = train_mod.train(cfg, steps=5, global_batch=2, seq_len=16, ckpt_dir=d,
                             ckpt_every=5, opt=opt, device="cpu")
    assert report["final_step"] == 15
    assert store.latest_step(d) == 15
    whole = train_mod.train(cfg, steps=15, global_batch=2, seq_len=16, opt=opt, device="cpu")
    assert report["losses"] == whole["losses"][10:]


def test_train_driver_quantized_resume(tmp_path):
    """8-bit moments through a checkpoint: the resumed run continues the
    uninterrupted one bit for bit on the CPU."""
    cfg = configs.get_reduced("qwen2-1.5b")
    opt = AdamW(peak_lr=1e-3, warmup_steps=1, total_steps=6, quantize_states=True)
    d = str(tmp_path / "q")
    kw = dict(global_batch=2, seq_len=16, opt=opt, device="cpu")
    train_mod.train(cfg, steps=4, ckpt_dir=d, ckpt_every=2, **kw)
    resumed = train_mod.train(cfg, steps=2, ckpt_dir=d, ckpt_every=2, **kw)
    whole = train_mod.train(cfg, steps=6, **kw)
    assert resumed["final_step"] == 6 and resumed["losses"] == whole["losses"][4:]


class _WorldMesh:
    def __init__(self, world, axes=None):
        self.world, self.device_type = world, "cpu"
        if axes is not None:
            self.mesh_dim_names, self.shape = tuple(axes), tuple(axes.values())

    def size(self):
        return self.world


def test_train_driver_mesh_and_device_rule(monkeypatch):
    """A model axis > 1 takes every token model (SSM mixers included, which
    then reach the process-group check); a mesh of several ranks needs its
    ranks on named axes and a process group; a world of one trains."""
    cfg = configs.get_reduced("qwen3-8b")
    with pytest.raises(RuntimeError, match="initialise torch.distributed"):
        train_mod.train(configs.get_reduced("xlstm-1.3b"), steps=1,
                        mesh=_WorldMesh(2, {"data": 1, "model": 2}))
    with pytest.raises(RuntimeError, match="initialise torch.distributed"):
        train_mod.train(cfg, steps=1, mesh=_WorldMesh(2, {"data": 1, "model": 2}))
    with pytest.raises(ValueError, match="pod, data and model"):
        train_mod.train(cfg, steps=1, mesh=_WorldMesh(2))
    with pytest.raises(RuntimeError, match="initialise torch.distributed"):
        train_mod.train(cfg, steps=1, mesh=_WorldMesh(2, {"data": 2, "model": 1}))
    report = train_mod.train(cfg, steps=2, global_batch=1, seq_len=8, mesh=_WorldMesh(1))
    assert report["final_step"] == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_mod.train(cfg, steps=1)


def test_train_cli(capsys):
    report = train_mod.main(["--arch", "qwen2-1.5b", "--reduced", "--device", "cpu",
                             "--steps", "3", "--batch", "2", "--seq", "8"])
    assert report["final_step"] == 3
    assert "done: 3 steps" in capsys.readouterr().out
