#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each reported on its own lines:

1. Card and toolchain: the card's name and power limit, ``torch.version.cuda``
   and ``nvcc --version``; then the kernels are built from
   ``src/repro_torch/kernels/csrc/`` (``nvcc``, ``sm_90a``).
2. Kernel checks: every CUDA kernel against its plain PyTorch version on the
   same CUDA tensors, at the shapes the main path gives it, with chunk
   invariance bit for bit; each timed with CUDA events (the median of three
   timed groups) beside its plain version, its bound and one library call as
   a yardstick.  Each Gram shape logs the reduction path and border source
   it took.  The IHB update is checked as an in-place chain and as the
   degree's whole candidate loop in one launch (``ihb_degree``).  The class
   axis of all three (``gram_update_acc``, ``ihb_update``, ``ihb_degree``
   for k classes in one launch) is checked against the per-class plain
   versions and, lane by lane, bit for bit against the one-class calls, at
   the class-batched main paths' shapes (k = 2 classes of 1,048,576 rows at
   L = K = 64; k = 2 spam-wide classes at Lcap = 2048), each timed beside k
   one-class launches, its bound and the batched gather + ``baddbmm``.
3. Main path, paper scale: Algorithm 2 (``VanishingIdealClassifier``, OAVI
   fast engine, psi = 0.005, its default ``class_batch="auto"``: the two
   classes fitted as one batched group) on the 2,000,000-sample Appendix C
   set, 60/40 split; the per-class fits are then run again on the CPU and
   compared, and the generators alone are timed batched beside sequential.
4. Main path, wide: one OAVI fit on class 0 of the spam-shaped set (n = 57),
   which grows to Lcap = Kcap = 2048; compared with the same fit on the CPU;
   one more wide fit under ``torch.profiler`` (device busy share, kernel time
   by name).
5. Flash attention: the CUDA kernel in bf16 against its plain version
   computed in fp32 from the same bf16 inputs, at the serve shape (Qwen3-8B,
   batch 4, 2048 tokens), a ragged causal length, a ragged non-causal key
   length and dv != d; the bf16 plain version's own error beside it; each
   timed beside its bound, the plain version and PyTorch's
   ``scaled_dot_product_attention``.  Each shape logs the kernel variant it
   took; the serve shape must take the wgmma one.
6. Main path, LM serving: ``launch.serve.serve`` of Qwen3-8B at its full
   width (36 layers, random weights from seed 0), batch 4, 2048-token
   prompts, 32 generated tokens; the prefill must launch the kernel once per
   layer.  The same model's prefill logits and one teacher-forced decode step
   are then held against the model run with the plain attention and against
   an fp32 copy of it.
7. The paper's oracle variants: ``api.fit_classes(class_batch="off")`` of
   each of the seven variants of Section 6.1 (CGAVI-IHB, AGDAVI-IHB,
   BPCGAVI-WIHB, BPCGAVI, PCGAVI, CGAVI, AGDAVI) on the card at paper scale
   (the phase-3 split),
   each held against the same fits on the CPU; the single in-place
   ``ihb_update`` kernel must be launched once per candidate by the IHB-warm
   variants.  Then Algorithm 2 with CGAVI-IHB (accuracy >= 0.8), saved and
   loaded into a fresh classifier on the card (identical labels); and a wide
   CGAVI-IHB fit on the phase-4 data, timed, against the phase-4 fast fit's
   structure.
8. The paper's baselines (Table 3): (a) ``api.fit_classes`` with ABM
   (``cap_terms=64``; its Gram is hand-written kernel 3, ``gram_update``,
   which must launch once per degree) and with VCA at paper scale (the
   phase-3 split), each held against the same fits on the CPU, kernel 3
   checked at the shape ABM gave it, and one ABM class fit profiled; (b)
   Table 3 on ``uci_like("skin")`` at full size: Algorithm 2 with ABM and
   with VCA, held against the CPU's labels, the VCA classifier saved and
   loaded (identical labels), and the polynomial-kernel SVM, held against
   the CPU on its first iterations; (c) VCA on the phase-4 data, where
   degree 2 has 3,136 candidates, against its CPU fit.
9. Class-batched OAVI (``api.fit_classes`` with its default
   ``class_batch="auto"``), each fit held bit for bit against the same
   classes fitted one after another on the card, and against the CPU: (a)
   the phase-3 classes (one group at m_cap = 1,048,576; A is 2 x 1,048,576
   x 64 fp32) with ``fast`` and ``cgavi-ihb``, one Gram launch a degree for
   the group, the batched and the sequential ``cgavi-ihb`` fits profiled;
   (b) 16 lognormal-skewed classes (``multiclass_planted(lognormal_sizes(16,
   4096, seed=16), n=4, seed=116)``, the reference's multi-class benchmark
   regime) with ``fast`` and BPCG + IHB, its groups, padding and schedule
   escalations printed; (c) both classes of the spam-shaped set with
   ``fast`` (Lcap = 2048: the batched ``ihb_degree`` at full width).
10. Out-of-core and incremental OAVI (``repro_torch.streaming``,
   ``repro_torch.online``): the streamed fit's kernels at its shapes (the
   carried Gram at 4,096- and 65,536-row chunks, ``ihb_degree`` at paper
   scale's degree 2); (a) streamed ``fast`` and ``cgavi-ihb`` fits of the
   scaled planted stream (131,072 rows) at chunk_rows 256, 1,024 and 4,096,
   each bit for bit the card's in-memory fit, prefetch on equal to off; (b)
   class 0 of the Appendix C set streamed at 4,096-row chunks: the
   in-memory fit's bits, and held against the CPU's streamed fit; (c) the
   streamed ``fast`` fit at m = 131,072, 2,097,152 and 16,777,216 (seconds,
   chunks, peak device bytes within 1.5x across the sweep), at 16,777,216
   rows also with 65,536-row chunks and in memory (bit-identical), and one
   streamed fit profiled; (d) ``online.fit`` on the first 15/16 of the
   largest stream, then ``api.update`` with the rest, bit for bit the
   streamed refit, again from a saved and loaded ``FitState``; (e) the
   16 skewed classes of 9b class-batched with ``chunk_rows=4096`` (``fast``
   and BPCG + IHB), each model bit for bit its class's own streamed fit.
11. Serving and observability (``repro_torch.serving``, ``repro_torch.obs``):
   (a) the phase-3 classifier saved, then served by
   ``launch.serve_vi.main(["--model-dir", ...])`` (``ModelRegistry.load``
   on the card, every bucket from 64 to 16,384 warmed): 2,048 requests of
   ``synth_trace(mean_rows=128, seed=0)``, 8 closed-loop clients, a 2 ms
   window, once ``predict`` and once ``transform`` inside a
   ``torch.profiler`` window (``OBS_TORCH_PROFILE``); every reply held bit
   for bit against the direct ``api.feature_transform`` (labels against
   the classifier's head), 0 recompiles, 0 hand-kernel launches; (b) the
   800,000-row test split through the engine, bit-equal to the direct
   transform; (c) a hot swap with an injected activation failure, each
   version's replies against its own direct path, and a replay with one
   transient fault and one poison request (every other reply bit-equal to
   the fault-free one); (d) an engine over phase 4's wide model (one
   ``addcmul`` launch a term of its book a call); (e) phase 3's generator
   fit with obs on (spans as ``record_function`` ranges, a profiler
   window) against obs off: identical bits, the timing contract to 1e-9 s,
   ``flops_per_degree`` equal to this script's ``gram_work`` and
   ``degree_work`` at the shapes the fit dispatched, the exported trace
   validated and rendered by ``launch.obs_report``.
12. The continuous controller (``launch.continuous_vi``, ``launch.chaos_vi``,
   ``resilience.journal``): (a) ``continuous_vi.main`` on the card: a
   2,097,152-row base (n = 3) and 4 arrivals of 131,072 rows (the third
   drifted), 65,536-row chunks, 2 probe threads; 0 bitwise mismatches,
   every arrival activated, one Gram launch a folded chunk and one
   ``ihb_degree`` a degree on every update, the final model bit for bit the
   card's streamed refit of every row and held against the CPU's by the
   float64 witness; one update profiled; (b) ``chaos_vi.main(["--fast",
   "--device", "cuda"])``: the six scenarios, resumed models bit-identical
   to the card's uninterrupted run; (c) (a)'s journal replayed: base_fitted,
   the ingests, each update's four transitions in order, done.
13. Data-parallel OAVI (``core.distributed``, ``backend="sharded"``): (a) a
   world of one over NCCL: phase 3's classes (``api.fit_classes``), class 0
   alone and the planted stream of 2,097,152 rows at 65,536-row chunks,
   each bit for bit the local card fit with one all_reduce and the local
   fit's launches a degree; (b) class 0 on two ranks of the one card
   (gloo, spawned processes): both ranks' models bit-identical, the local
   card fit's structure, the float64-witness rule.

Every check that fails raises, and the script exits non-zero before its last
line.  It needs a CUDA card and the repository's ``src/`` beside it.  The last
lines are the kernels' JSON record, the ``nvidia-smi`` name and power limit,
and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PSI = 0.005
# published peaks of one H100 SXM (fp32 outside the tensor cores, bf16 dense
# on them; HBM3)
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# kernel vs plain version: the same fp32 products, each 256-row block summed
# in another order, the blocks folded in the same order.  Gram entries are
# sums of non-negative terms, so a block's partial moves by ~sqrt(256)*eps
# relative and the fold averages that over the blocks: far below 1e-6.  TF32
# products (inputs rounded to 10 bits) moved the entries by 5.1e-6 to 3.8e-5
# at the shapes below on an H100; a control run of the plain version with
# TF32 must fail this tolerance.
GRAM_RTOL = 1e-6
# IHB chains on well-conditioned columns (condition number ~10)
IHB_RTOL, IHB_ATOL = 1e-4, 1e-5
# the degree loop chains up to ~800 such updates (kappa of the Gram ~10), each
# matvec summed in another order: the tolerance of tests/test_torch_gpu.py
IHB_DEGREE_RTOL, IHB_DEGREE_ATOL = 1e-3, 1e-4
# card fit vs CPU fit: the Theorem 4.9 inverse engine amplifies fp32
# summation-order noise by kappa(A)^2 (up to ~3e-3 on the 58-term spam fit),
# so both fp32 fits are held against numpy's float64 least-squares solution
# on the same data: the card may be no further from it than twice the CPU
# fp32 fit, or 1e-4.  A control fit with TF32 products is reported beside
# it: its coefficients can be as accurate as fp32 ones, so this check does
# not stand guard against TF32; the Gram tolerance above does.
FIT_ERR_FACTOR, FIT_ERR_FLOOR = 2.0, 1e-4
# At paper scale (kappa small) the card's and the CPU's coefficients are also
# held allclose at the parity tests' tolerance; on the wide fit the card's and
# the CPU's fp32 fits differ by several 1e-3, each about as far from the
# float64 solution, so it is not.
FIT_DIRECT_TOL = (1e-4, 1e-5)
BAND = 1e-3  # verdicts within BAND * psi of psi may flip between sum orders
# flash kernel (bf16) vs the plain version in fp32 on the same bf16 inputs:
# the JAX package's tolerance for its bf16 flash kernel (tests/test_kernels.py);
# the output's own bf16 rounding is up to 2^-9 relative, p's rounding to bf16
# adds as much again
FLASH_TOL = 2e-2
# LM logits: the kernel model and the plain-attention model are both bf16 and
# differ only in attention's roundings (the kernel keeps the scores in fp32,
# the plain version rounds them to bf16 before the softmax).  How far bf16
# rounding moves these logits at this depth is measured in the run: the plain
# bf16 model's distance from an fp32 copy of the same weights.  The kernel
# model may be no further from the fp32 model than LM_FACTOR times that, and
# no further from the plain bf16 model than LM_FACTOR times that either; a
# wrong mask or head mapping moves logits by their whole spread instead.
LM_FACTOR = 2.0


def log(*parts):
    print(*parts, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 2, groups: int = 3) -> float:
    """Milliseconds per call: the median over ``groups`` timed groups of
    ``reps`` back-to-back calls each, CUDA events around each group."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(groups):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / reps)
    return float(np.median(per_call))


def device_ms(fn, kernel: str, reps: int) -> float:
    """Milliseconds of device time per launch of the kernel whose name
    contains ``kernel``, over ``reps`` calls of ``fn`` under
    ``torch.profiler``: what the card spends, where a host-bound loop's
    CUDA-event time measures the host."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [ev for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and kernel in ev.key]
    count = sum(ev.count for ev in rows)
    if count != reps:
        raise AssertionError(f"profiled {count} launches of {kernel}, expected {reps}")
    return sum(ev.self_device_time_total for ev in rows) / 1e3 / count


def bound(flops: float, nbytes: float, peak: float = PEAK_FP32_FLOPS):
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def rate_note(flops, ms, b_ms):
    """Achieved TFLOP/s and the share of the bound reached."""
    return f"{flops / ms / 1e9:.1f} TFLOP/s, {100 * b_ms / ms:.1f}% of bound"


def close(got, want, rtol, atol):
    """Largest absolute error, and whether every entry is within tolerance."""
    import torch

    err = (got - want).abs()
    return float(err.max()), bool(torch.all(err <= atol + rtol * want.abs()))


def check_close(name, got, want, rtol, atol):
    worst, ok = close(got, want, rtol, atol)
    log(f"  {name}: max_abs_err {worst:.6g} (tolerance {atol:.3g} + {rtol:.1g}*|plain|)")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return worst


# ---------------------------------------------------------------------------
# Phase 2: kernels
# ---------------------------------------------------------------------------


def gram_inputs(rng, m, L, n, K, dev):
    """m data rows, zero-padded to a multiple of 512 rows as the fit pads."""
    import torch

    m_pad = -(-m // 512) * 512
    A = torch.zeros((m_pad, L), dtype=torch.float32, device=dev)
    X = torch.zeros((m_pad, n), dtype=torch.float32, device=dev)
    A[:m] = torch.from_numpy(rng.uniform(0, 1, (m, L)).astype(np.float32)).to(dev)
    X[:m] = torch.from_numpy(rng.uniform(0, 1, (m, n)).astype(np.float32)).to(dev)
    p = torch.from_numpy(rng.integers(0, L, K)).to(dev)
    v = torch.from_numpy(rng.integers(0, n, K)).to(dev)
    return A, X, p, v


def gram_work(A, X, p, carry: bool):
    """Least work of the Gram function on these inputs: B = A[:, p] * X[:, v]
    (m*K products), QL = A^T B (2*m*L*K) and the upper triangle of the
    symmetric C = B^T B (m*K*(K+1)); every input read once, QL and C written
    once (and the carry read once)."""
    m, L = A.shape
    n, K = X.shape[1], p.shape[0]
    flops = m * K + 2.0 * m * L * K + 1.0 * m * K * (K + 1)
    nbytes = (A.element_size() * (m * L + m * n) + 2 * p.element_size() * K
              + A.element_size() * (L * K + K * K) * (2 if carry else 1))
    return flops, nbytes


def check_gram_acc(dev, m, L, n, K, split_blocks, reps):
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.gram_update import borders, gram_update_acc, path

    rng = np.random.default_rng(m + L)
    A, X, p, v = gram_inputs(rng, m, L, n, K, dev)
    ql0 = torch.from_numpy(rng.uniform(0, 1, (L, K)).astype(np.float32)).to(dev)
    c0 = torch.from_numpy(rng.uniform(0, 1, (K, K)).astype(np.float32)).to(dev)
    bm = ops.GRAM_BLOCK
    got = ops.gram_accumulate(A, X, p, v, (ql0, c0))
    want = ops.gram_accumulate(A, X, p, v, (ql0, c0), use_kernel=False)
    torch.cuda.synchronize()
    tag = f"gram_update_acc m={m} L={L} n={n} K={K}"
    kind = f"{path(L, K, dev)} path, borders {borders(L, n)}"
    log(f"  {tag}: {kind}")
    err = max(check_close(f"{tag} {nm}", g, w, GRAM_RTOL, 0.0)
              for nm, g, w in zip(("QL", "C"), got, want))
    torch.backends.cuda.matmul.allow_tf32 = True
    tf32 = ops.gram_accumulate(A, X, p, v, (ql0, c0), use_kernel=False)
    torch.backends.cuda.matmul.allow_tf32 = False
    verdicts = [close(t, w, GRAM_RTOL, 0.0) for t, w in zip(tf32, want)]
    rel = max(float(((t - w).abs() / w.abs()).max()) for t, w in zip(tf32, want))
    log(f"  {tag}: control, the plain version with TF32 products: max_abs_err "
        f"{max(e for e, _ in verdicts):.6g}, max relative error {rel:.3g}, within "
        f"tolerance: {[ok for _, ok in verdicts]}")
    if all(ok for _, ok in verdicts):
        raise AssertionError(f"{tag}: the tolerance does not tell TF32 from fp32")
    # chunk invariance: two carried calls split at 256*k rows == one call
    s = split_blocks * bm
    first = ops.gram_accumulate(A[:s], X[:s], p, v, (ql0, c0))
    chained = ops.gram_accumulate(A[s:], X[s:], p, v, first)
    for a, b in zip(got, chained):
        if not torch.equal(a, b):
            raise AssertionError(f"{tag}: chunked at {s} rows is not bit-identical")
    log(f"  {tag}: chunked at {s} rows bit-identical to one call")

    def library():
        B = A[:, p] * X[:, v]
        return torch.addmm(ql0, A.T, B), torch.addmm(c0, B.T, B)

    ms = time_ms(lambda: gram_update_acc(A, X, p, v, ql0, c0, bm=bm), reps)
    plain_ms = time_ms(lambda: ops.gram_accumulate(A, X, p, v, (ql0, c0),
                                                   use_kernel=False), max(1, reps // 4))
    lib_ms = time_ms(library, reps)
    flops, nbytes = gram_work(A, X, p, carry=True)
    b_ms, b_by = bound(flops, nbytes)
    log(f"  {tag}: kernel {ms:.4f} ms ({rate_note(flops, ms, b_ms)}), plain {plain_ms:.4f} ms, "
        f"library {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms, variant=kind, shape=dict(m=m, L=L, n=n, K=K))


def check_gram_update(dev, m, L, n, K, reps):
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.gram_update import borders, gram_update, path

    rng = np.random.default_rng(m + 7)
    A, X, p, v = gram_inputs(rng, m, L, n, K, dev)
    got = ops.gram_update(A, X, p, v, bm=512)
    zeros = (A.new_zeros((L, K)), A.new_zeros((K, K)))

    def plain():  # the kernel's semantics: zero carry, 512-row blocks in order
        return ref.gram_accumulate_ref(A, X, p, v, *zeros, bm=512)

    want = plain()
    torch.cuda.synchronize()
    tag = f"gram_update m={m} L={L} n={n} K={K} bm=512"
    kind = f"{path(L, K, dev)} path, borders {borders(L, n)}"
    log(f"  {tag}: {kind}")
    err = max(check_close(f"{tag} {nm}", g, w, GRAM_RTOL, 0.0)
              for nm, g, w in zip(("QL", "C"), got, want))

    def library():
        B = A[:, p] * X[:, v]
        return A.T @ B, B.T @ B

    ms = time_ms(lambda: gram_update(A, X, p, v, bm=512), reps)
    plain_ms = time_ms(plain, max(1, reps // 4))
    lib_ms = time_ms(library, reps)
    flops, nbytes = gram_work(A, X, p, carry=False)
    b_ms, b_by = bound(flops, nbytes)
    log(f"  {tag}: kernel {ms:.4f} ms ({rate_note(flops, ms, b_ms)}), plain {plain_ms:.4f} ms, "
        f"library {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms, variant=kind, shape=dict(m=m, L=L, n=n, K=K))


def check_ihb(dev, L, steps, reps):
    """A chain of ``steps`` in-place appends from ell = L / 2, kernel chain
    vs plain chain, on well-conditioned (Gaussian) columns; then one update
    timed with ``N`` fixed and a separate output buffer, and a gated-off
    launch."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.ihb_update import ihb_update_

    rng = np.random.default_rng(L)
    m = 4 * L
    cols = rng.standard_normal((m, L))
    G = cols.T @ cols / m  # float64 Gram of all L columns
    ell0 = L // 2
    N0 = np.eye(L)
    N0[:ell0, :ell0] = np.linalg.inv(G[:ell0, :ell0])
    Nk = torch.tensor(N0, dtype=torch.float32, device=dev)
    Np = Nk.clone()
    qs, btbs, ells = [], [], []
    for s in range(steps):
        ell = ell0 + s
        q = np.zeros(L)
        q[:ell] = G[:ell, ell]
        qs.append(torch.tensor(q, dtype=torch.float32, device=dev))
        btbs.append(torch.tensor(G[ell, ell], dtype=torch.float32, device=dev))
        ells.append(torch.tensor(ell, dtype=torch.int32, device=dev))
    for s in range(steps):
        ops.ihb_update_(Nk, qs[s], btbs[s], ells[s])
        Np = ops.ihb_update(Np, qs[s], btbs[s], ells[s], use_kernel=False)
    torch.cuda.synchronize()
    tag = f"ihb_update L={L} chain of {steps} in-place appends from ell={ell0}"
    err = check_close(tag, Nk, Np, IHB_RTOL, IHB_ATOL)
    end = ell0 + steps
    if not torch.equal(Nk[end:, end:], torch.eye(L - end, device=dev)):
        raise AssertionError(f"{tag}: identity padding beyond ell={end} changed")
    log(f"  {tag}: identity padding beyond ell={end} bit-exact")

    N1, q1, b1, ell1 = Nk.clone(), qs[-1], btbs[-1], ells[-1]
    off = torch.tensor(False, device=dev)
    ihb_update_(N1, q1, b1, ell1, active=off)
    torch.cuda.synchronize()
    if not torch.equal(N1, Nk):
        raise AssertionError(f"{tag}: a gated-off launch changed N")
    log(f"  {tag}: a gated-off launch leaves N bit-identical")
    Nout = N1.clone()
    alpha = 1.0 / float(b1)

    def library():
        u = torch.mv(N1, q1)
        return torch.addr(N1, u, u, alpha=alpha)

    # N1 fixed and Nout a separate buffer: the in-place update's bytes, and
    # repeated launches do not drift the chain's numbers
    ms = time_ms(lambda: ihb_update_(N1, q1, b1, ell1, out=Nout), reps)
    off_ms = time_ms(lambda: ihb_update_(N1, q1, b1, ell1, active=off), reps)
    dev_ms = device_ms(lambda: ihb_update_(N1, q1, b1, ell1, out=Nout),
                       "ihb_update_kernel", reps)
    off_dev_ms = device_ms(lambda: ihb_update_(N1, q1, b1, ell1, active=off),
                           "ihb_update_kernel", reps)
    plain_ms = time_ms(lambda: ref.ihb_update_ref(N1, q1, b1, ell1), reps)
    lib_ms = time_ms(library, reps)
    # q is zero and N the identity from ell on, so u = N q and the rank-1
    # update need only the leading block: e^2 entries of N read once, the
    # (e+1)^2 block written once, q's e entries and two scalars
    e = end - 1
    flops = 2.0 * e * e + 2.0 * e + 3.0 * (e + 1) ** 2
    b_ms, b_by = bound(flops, 4.0 * (e * e + (e + 1) ** 2 + e + 2))
    full_ms, _ = bound(flops, 4.0 * (2 * L * L + L + 1) + 4)
    log(f"  ihb_update L={L} ell={e}: kernel {ms:.4f} ms (gated off {off_ms:.4f} ms), "
        f"of it on the device {dev_ms:.4f} ms (gated off {off_dev_ms:.4f} ms), "
        f"plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}; "
        f"the full-L^2 bound of earlier runs {full_ms:.6f} ms)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms, gated_off_ms=off_ms,
                device_ms=dev_ms, gated_off_device_ms=off_dev_ms,
                full_l2_bound_ms=full_ms, shape=dict(L=L, ell=e))


def degree_inputs(seed, Lcap, ell0, K, appended, Kcap):
    """Normalized Gram blocks of one degree, QL transposed, as ``stats_step``
    hands them to the candidate loop: ``ell0`` Gaussian columns in O (N
    their exact inverse, padded with the identity) and K candidates, of which
    those with ``appended[a]`` are independent (MSE near 1: appended) and the
    others a combination of O's columns plus noise of variance psi / 5
    (accepted).  The same construction as ``tests/test_torch_gpu.py``."""
    rng = np.random.default_rng(seed)
    m = 4 * (ell0 + K)
    A = rng.standard_normal((m, ell0))
    B = rng.standard_normal((m, K))
    dep = ~np.asarray(appended)
    B[:, dep] = (A @ rng.standard_normal((ell0, dep.sum())) / np.sqrt(ell0)
                 + np.sqrt(PSI / 5) * rng.standard_normal((m, dep.sum())))
    N = np.eye(Lcap)
    N[:ell0, :ell0] = np.linalg.inv(A.T @ A / m)
    QLt = np.zeros((Kcap, Lcap))
    QLt[:K, :ell0] = (A.T @ B / m).T
    C = np.zeros((Kcap, Kcap))
    C[:K, :K] = B.T @ B / m
    return [x.astype(np.float32) for x in (QLt, C, N)]


def degree_work(acc, ell0, K, Lcap):
    """Least work of one degree's candidate loop on this run's decisions:
    candidate a reads ell_a entries of its QL row (plus one C entry per
    column appended this degree) and its btb; the initial block of N is read
    once and the final one written once; every output is written once.
    Operations: the matvec and the Schur reduction of every candidate, and
    the rank-1 update of every append."""
    ells = ell0 + np.concatenate([[0], np.cumsum(~acc)[:-1]])
    ell_f = ell0 + int((~acc).sum())
    flops = float(np.sum(2.0 * ells ** 2 + 3.0 * ells - ell0)
                  + np.sum((3.0 * ells ** 2 + 2.0 * ells + 1)[~acc]))
    nbytes = (4.0 * (np.sum(2 * ells - ell0) + K + ell0 ** 2 + ell_f ** 2 + K * Lcap + K)
              + 8.0 * K + K + 4)
    return float(flops), float(nbytes)


def check_ihb_degree(dev, Lcap, ell0, K, Kcap, reps):
    """The degree's candidate loop in one launch against the plain eager
    loop, on Grams where about half the candidates are appended."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.ihb_update import ihb_degree

    rng = np.random.default_rng(Lcap + ell0 + K)
    appended = rng.uniform(size=K) < 0.5
    QLt, C, N0 = (torch.from_numpy(x).to(dev)
                  for x in degree_inputs(K + ell0, Lcap, ell0, K, appended, Kcap))
    Nk, Np = N0.clone(), N0.clone()
    got = ops.ihb_degree(QLt, C, Nk, ell0, PSI, K)
    want = ops.ihb_degree(QLt, C, Np, ell0, PSI, K, use_kernel=False)
    torch.cuda.synchronize()
    tag = f"ihb_degree Lcap={Lcap} ell0={ell0} K={K}"
    acc, p_acc = got[0].cpu().numpy(), want[0].cpu().numpy()
    p_mses = want[1].cpu().numpy()
    banded = np.nonzero(np.abs(p_mses - PSI) <= BAND * PSI)[0]
    stop = int(banded[0]) if banded.size else K
    if not (np.array_equal(acc[:stop], p_acc[:stop])
            and torch.equal(got[3][:stop], want[3][:stop])):
        raise AssertionError(f"{tag}: kernel and plain verdicts differ")
    log(f"  {tag}: {int((~p_acc).sum())} appended, final ell {int(want[4])}; verdicts "
        f"and slots equal on {stop} of {K} candidates"
        + ("" if stop == K else f" (candidate {stop}'s MSE lies in the band)"))
    err = 0.0
    if stop == K:
        if int(got[4]) != int(want[4]):
            raise AssertionError(f"{tag}: final ell {int(got[4])} != {int(want[4])}")
        err = max(check_close(f"{tag} {nm}", g, w, IHB_DEGREE_RTOL, IHB_DEGREE_ATOL)
                  for nm, g, w in (("mses", got[1], want[1]), ("coeffs", got[2], want[2]),
                                   ("N", Nk, Np)))
        e = int(got[4])
        if not (torch.equal(Nk[e:], N0[e:]) and torch.equal(Nk[:, e:], N0[:, e:])):
            raise AssertionError(f"{tag}: N changed past the final ell={e}")
        log(f"  {tag}: N past the final ell={e} bit-exact")
    again = N0.clone()
    out2 = ops.ihb_degree(QLt, C, again, ell0, PSI, K)
    if not (torch.equal(again, Nk) and all(torch.equal(a, b) for a, b in zip(got, out2))):
        raise AssertionError(f"{tag}: two launches gave different bits")
    log(f"  {tag}: two launches bit-identical")

    Nw = N0.clone()

    def reset():
        Nw.copy_(N0)

    # each launch updates N in place, so each timed call first restores it;
    # the restore is timed alone and taken off
    ms = time_ms(lambda: (reset(), ihb_degree(QLt, C, Nw, ell0, PSI, K)), reps)
    ms -= time_ms(reset, reps)
    plain_ms = time_ms(lambda: (reset(), ops.ihb_degree(QLt, C, Nw, ell0, PSI, K,
                                                        use_kernel=False)),
                       1, warmup=1, groups=1)
    flops, nbytes = degree_work(p_acc, ell0, K, Lcap)
    b_ms, b_by = bound(flops, nbytes)
    log(f"  {tag}: kernel {ms:.4f} ms ({1e3 * ms / K:.2f} us a candidate), plain "
        f"{plain_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}: {flops / 1e6:.2f} MFLOP, "
        f"{nbytes / 1e6:.2f} MB)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, appended=int((~p_acc).sum()),
                shape=dict(Lcap=Lcap, ell0=ell0, K=K, Kcap=Kcap))


def check_gram_batched(dev, k, m_cap, L, n, K, reps):
    """``gram_update_acc`` with a class axis: k classes of m_cap rows in one
    launch, against the per-class plain version and, lane by lane, bit for
    bit against the one-class kernel call; timed beside k one-class launches,
    the plain version and the batched gather + ``baddbmm``."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.gram_update import (borders, gram_update_acc,
                                                 gram_update_acc_batched, path)

    rng = np.random.default_rng(m_cap + L + k)
    A, X, p, v = (torch.stack(t) for t in zip(*(gram_inputs(rng, m_cap, L, n, K, dev)
                                                for _ in range(k))))
    ql0 = torch.from_numpy(rng.uniform(0, 1, (k, L, K)).astype(np.float32)).to(dev)
    c0 = torch.from_numpy(rng.uniform(0, 1, (k, K, K)).astype(np.float32)).to(dev)
    bm = ops.GRAM_BLOCK
    got = ops.gram_accumulate_batched(A, X, p, v, (ql0, c0))
    want = ops.gram_accumulate_batched(A, X, p, v, (ql0, c0), use_kernel=False)
    singles = [ops.gram_accumulate(A[c], X[c], p[c], v[c], (ql0[c], c0[c])) for c in range(k)]
    torch.cuda.synchronize()
    tag = f"gram_update_acc_batched k={k} m_cap={m_cap} L={L} n={n} K={K}"
    kind = f"{path(L, K, dev)} path, borders {borders(L, n)} (each lane's, as alone)"
    log(f"  {tag}: {kind}")
    err = max(check_close(f"{tag} {nm}", g, w, GRAM_RTOL, 0.0)
              for nm, g, w in zip(("QL", "C"), got, want))
    for c, one in enumerate(singles):
        if not (torch.equal(got[0][c], one[0]) and torch.equal(got[1][c], one[1])):
            raise AssertionError(f"{tag}: lane {c} differs from its one-class call")
    log(f"  {tag}: every lane bit-identical to its one-class kernel call")

    def library():
        idx = (k, A.shape[1], K)
        B = (torch.gather(A, 2, p[:, None, :].expand(idx))
             * torch.gather(X, 2, v[:, None, :].expand(idx)))
        return torch.baddbmm(ql0, A.transpose(1, 2), B), torch.baddbmm(c0, B.transpose(1, 2), B)

    ms = time_ms(lambda: gram_update_acc_batched(A, X, p, v, ql0, c0, bm=bm), reps)
    singles_ms = time_ms(lambda: [gram_update_acc(A[c], X[c], p[c], v[c], ql0[c], c0[c], bm=bm)
                                  for c in range(k)], reps)
    plain_ms = time_ms(lambda: ops.gram_accumulate_batched(A, X, p, v, (ql0, c0),
                                                           use_kernel=False), max(1, reps // 4))
    lib_ms = time_ms(library, reps)
    flops, nbytes = gram_work(A[0], X[0], p[0], carry=True)
    b_ms, b_by = bound(k * flops, k * nbytes)
    log(f"  {tag}: kernel {ms:.4f} ms ({rate_note(k * flops, ms, b_ms)}), {k} one-class "
        f"launches {singles_ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, one_class_launches_ms=singles_ms, variant=kind,
                shape=dict(k=k, m_cap=m_cap, L=L, n=n, K=K))


def check_ihb_degree_batched(dev, Lcap, Kcap, shapes, reps):
    """``ihb_degree`` with a class axis: one cooperative launch for the
    classes ``shapes = [(ell0, K), ...]``, against the per-class plain loop
    and, lane by lane, bit for bit against the one-class kernel call (which
    takes another grid, and perhaps another band layout)."""
    import torch

    from repro_torch.kernels import ihb_update as ihb_kernels
    from repro_torch.kernels import ops

    k = len(shapes)
    ell0s, Ks = [e for e, _ in shapes], [K for _, K in shapes]
    rows_max = max(e + K for e, K in shapes)
    rng = np.random.default_rng(Lcap + k)
    apps = [rng.uniform(size=K) < 0.5 for K in Ks]
    QLt, C, N0 = (torch.from_numpy(np.stack(x)).to(dev) for x in zip(*(
        degree_inputs(K + e + c, Lcap, e, K, a, Kcap)
        for c, ((e, K), a) in enumerate(zip(shapes, apps)))))
    Nk, Np = N0.clone(), N0.clone()
    got = ops.ihb_degree_batched(QLt, C, Nk, ell0s, PSI, Ks)
    want = ops.ihb_degree_batched(QLt, C, Np, ell0s, PSI, Ks, use_kernel=False)
    torch.cuda.synchronize()
    G = ihb_kernels.lane_blocks(rows_max, k)
    lanes_note = [f"(ell0={e}, K={K}: {G} blocks, one-class call "
                  f"{ihb_kernels.lane_blocks(e + K, 1)}; band "
                  f"{'staged' if ihb_kernels.degree_staged(e, K, rows_max, k) else 'in L2'})"
                  for e, K in shapes]
    tag = f"ihb_degree_batched Lcap={Lcap} k={k}"
    log(f"  {tag}: lanes {', '.join(lanes_note)}")
    err = 0.0
    for c, (e, K) in enumerate(shapes):
        Nc = N0[c].clone()
        one = ops.ihb_degree(QLt[c], C[c], Nc, e, PSI, K)
        if not (all(torch.equal(g[c, :K], o) for g, o in zip(got[:4], one[:4]))
                and int(got[4][c]) == int(one[4]) and torch.equal(Nk[c], Nc)):
            raise AssertionError(f"{tag}: lane {c} differs from its one-class call")
        p_acc, p_mses = want[0][c, :K].cpu().numpy(), want[1][c, :K].cpu().numpy()
        banded = np.nonzero(np.abs(p_mses - PSI) <= BAND * PSI)[0]
        stop = int(banded[0]) if banded.size else K
        if not (np.array_equal(got[0][c, :stop].cpu().numpy(), p_acc[:stop])
                and torch.equal(got[3][c, :stop], want[3][c, :stop])):
            raise AssertionError(f"{tag}: lane {c}: kernel and plain verdicts differ")
        if stop == K:
            err = max(err, *(check_close(f"{tag} lane {c} {nm}", g, w, IHB_DEGREE_RTOL,
                                         IHB_DEGREE_ATOL)
                             for nm, g, w in (("mses", got[1][c], want[1][c]),
                                              ("coeffs", got[2][c], want[2][c]),
                                              ("N", Nk[c], Np[c]))))
    log(f"  {tag}: every lane bit-identical to its one-class kernel call")

    Nw = N0.clone()

    def reset():
        Nw.copy_(N0)

    ms = time_ms(lambda: (reset(), ops.ihb_degree_batched(QLt, C, Nw, ell0s, PSI, Ks)), reps)
    ms -= time_ms(reset, reps)
    singles_ms = time_ms(lambda: (reset(), [ops.ihb_degree(QLt[c], C[c], Nw[c], e, PSI, K)
                                            for c, (e, K) in enumerate(shapes)]), reps)
    singles_ms -= time_ms(reset, reps)
    plain_ms = time_ms(lambda: (reset(), ops.ihb_degree_batched(QLt, C, Nw, ell0s, PSI, Ks,
                                                                 use_kernel=False)),
                       1, warmup=1, groups=1)
    flops = nbytes = 0.0
    for c, (e, K) in enumerate(shapes):
        f_c, b_c = degree_work(want[0][c, :K].cpu().numpy(), e, K, Lcap)
        flops, nbytes = flops + f_c, nbytes + b_c
    b_ms, b_by = bound(flops, nbytes)
    log(f"  {tag}: kernel {ms:.4f} ms, {k} one-class launches {singles_ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, one_class_launches_ms=singles_ms, lanes=lanes_note,
                shape=dict(Lcap=Lcap, Kcap=Kcap, lanes=shapes))


def check_ihb_update_batched(dev, L, k, reps):
    """``ihb_update`` with a class axis: k in-place updates at slots ell_c in
    one launch, against the per-class plain update and, lane by lane, bit for
    bit against the one-class kernel call; a gated-off lane moves no byte."""
    import torch

    from repro_torch.kernels import ihb_update as ihb_kernels
    from repro_torch.kernels import ops, ref

    rng = np.random.default_rng(L + k)
    N0, q, btb, ells = [], [], [], []
    for c in range(k):
        ell = L // 2 + 7 * c
        cols = rng.standard_normal((4 * L, ell + 1))
        G = cols.T @ cols / (4 * L)
        N = np.eye(L)
        N[:ell, :ell] = np.linalg.inv(G[:ell, :ell])
        qc = np.zeros(L)
        qc[:ell] = G[:ell, ell]
        N0.append(N), q.append(qc), btb.append(G[ell, ell]), ells.append(ell)
    N0 = torch.tensor(np.stack(N0), dtype=torch.float32, device=dev)
    q = torch.tensor(np.stack(q), dtype=torch.float32, device=dev)
    btb = torch.tensor(btb, dtype=torch.float32, device=dev)
    ell = torch.tensor(ells, dtype=torch.int32, device=dev)
    Nk = N0.clone()
    ops.ihb_update_batched_(Nk, q, btb, ell)
    want = ops.ihb_update_batched_(N0.clone(), q, btb, ell, use_kernel=False)
    tag = f"ihb_update_batched L={L} k={k}"
    err = check_close(tag, Nk, want, IHB_RTOL, IHB_ATOL)
    for c in range(k):
        if not torch.equal(Nk[c], ops.ihb_update(N0[c], q[c], btb[c], ell[c])):
            raise AssertionError(f"{tag}: lane {c} differs from its one-class call")
    gate = torch.tensor([c % 2 == 0 for c in range(k)], device=dev)
    Ng = N0.clone()
    ops.ihb_update_batched_(Ng, q, btb, ell, active=gate)
    for c in range(k):
        if not torch.equal(Ng[c], Nk[c] if c % 2 == 0 else N0[c]):
            raise AssertionError(f"{tag}: gated lane {c} wrong")
    log(f"  {tag}: lanes bit-identical to their one-class calls ({ihb_kernels.lane_blocks(L, k)} "
        f"blocks a lane, {ihb_kernels.lane_blocks(L, 1)} alone); a gated-off lane moves no byte")
    Nw = N0.clone()

    def reset():
        Nw.copy_(N0)

    def library():
        u = torch.bmm(N0, q[:, :, None])
        return torch.baddbmm(N0, u, u.transpose(1, 2))

    ms = time_ms(lambda: (reset(), ops.ihb_update_batched_(Nw, q, btb, ell)), reps)
    ms -= time_ms(reset, reps)
    singles_ms = time_ms(lambda: (reset(), [ops.ihb_update_(Nw[c], q[c], btb[c], ell[c])
                                            for c in range(k)]), reps)
    singles_ms -= time_ms(reset, reps)
    plain_ms = time_ms(lambda: ref.ihb_update_batched_ref(N0, q, btb, ell), reps)
    lib_ms = time_ms(library, reps)
    flops = nbytes = 0.0
    for e in ells:  # the leading block of each lane, as for one update
        flops += 2.0 * e * e + 2.0 * e + 3.0 * (e + 1) ** 2
        nbytes += 4.0 * (e * e + (e + 1) ** 2 + e + 2)
    b_ms, b_by = bound(flops, nbytes)
    log(f"  {tag}: kernel {ms:.4f} ms, {k} one-class launches {singles_ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, one_class_launches_ms=singles_ms,
                shape=dict(L=L, k=k, ell=ells))


# ---------------------------------------------------------------------------
# Phases 3-4: main path
# ---------------------------------------------------------------------------


def recording_fit(fit_fn, module=None):
    """Run ``fit_fn`` with ``collect_degree`` of ``module`` (the port's OAVI,
    or ABM's) wrapped so every candidate's (term, mse, accepted) is logged;
    ABM's "mse" is the candidate's least eigenvalue."""
    from repro_torch.core import oavi

    module = module or oavi
    log_ = []
    inner = module.collect_degree

    def collect(book, border, accepted, mses, coeffs, generators):
        for i, (term, _, _) in enumerate(border):
            log_.append((term, float(mses[i]), bool(accepted[i])))
        return inner(book, border, accepted, mses, coeffs, generators)

    module.collect_degree = collect
    try:
        out = fit_fn()
    finally:
        module.collect_degree = inner
    return out, log_


@contextlib.contextmanager
def plain_tf32():
    """The control fit: every op on its plain version, with TF32 products."""
    import torch

    from repro_torch.kernels import ops

    inner, tf32 = ops._kernel_path, torch.backends.cuda.matmul.allow_tf32
    ops._kernel_path = lambda t, use_kernel: False
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        ops._kernel_path = inner


def _o_columns(model, X):
    """The data in the model's term order and its O columns, in float64."""
    Z = np.asarray(X, np.float64)
    if model.feature_perm is not None:
        Z = Z[:, model.feature_perm]
    parents, vars_ = model.book.parents, model.book.vars
    O = np.ones((Z.shape[0], len(parents)))
    for i in range(1, len(parents)):
        O[:, i] = O[:, parents[i]] * Z[:, vars_[i]]
    return Z, O


def lstsq_coeffs(model, X):
    """Every generator's coefficients as numpy's float64 least-squares
    solution over the O columns it was fitted on (the fast engine solves
    ``min_c |O c + lead|`` through the normal equations).  Only the structure
    comes from ``model``."""
    Z, O = _o_columns(model, X)
    by_len = {}
    for j, g in enumerate(model.generators):
        by_len.setdefault(len(g.coeffs), []).append(j)
    out = [None] * model.num_G
    for ell, js in by_len.items():
        lead = np.stack([O[:, model.generators[j].parent_idx]
                         * Z[:, model.generators[j].var] for j in js], axis=1)
        sol = np.linalg.lstsq(O[:, :ell], -lead, rcond=None)[0]
        for k, j in enumerate(js):
            out[j] = sol[:, k]
    return out


def abm_witness(model, X):
    """Every ABM generator's monic coefficients in float64: the least
    eigenvector of the float64 extended Gram ``[O_ell, lead]^T [O_ell, lead]
    / m`` over the O columns it was fitted on, divided by its leading entry.
    Only the structure comes from ``model``."""
    Z, O = _o_columns(model, X)
    out = []
    for g in model.generators:
        ell = len(g.coeffs)
        M = np.concatenate([O[:, :ell], (O[:, g.parent_idx] * Z[:, g.var])[:, None]], axis=1)
        v = np.linalg.eigh(M.T @ M / Z.shape[0])[1][:, 0]
        out.append(v[:ell] / v[ell])
    return out


def _structure(models):
    return [(m.book.terms, [g.term for g in m.generators]) for m in models]


def _coeff_err(models, witnesses):
    return max((float(np.abs(g.coeffs - w).max())
                for m, ws in zip(models, witnesses)
                for g, w in zip(m.generators, ws)), default=0.0)


def judge_structure(card_models, cpu_models, card_log, cpu_log):
    """Why the card's verdicts or structure differ from the CPU's (None if
    they agree), and whether a candidate's MSE lay in the band.

    Verdicts must be equal up to the first candidate whose MSE lies within
    BAND * psi of psi; with none in the band the structure must be equal."""
    banded = [i for i, (_, mse, _) in enumerate(cpu_log) if abs(mse - PSI) <= BAND * PSI]
    stop = banded[0] if banded else len(cpu_log)
    if [(t, a) for t, _, a in card_log[:stop]] != [(t, a) for t, _, a in cpu_log[:stop]]:
        return "verdicts differ", bool(banded)
    if banded:
        log(f"  candidate {cpu_log[stop]} lies within {BAND}*psi of psi; "
            f"verdicts compared up to it ({stop} candidates) and equal")
        return None, True
    if _structure(card_models) != _structure(cpu_models):
        return "structure differs", False
    return None, False


def judge_fits(card_models, cpu_models, card_log, cpu_log, witnesses, direct):
    """Why the card fits fail the check against the CPU fits (None if they
    pass), and the distances behind the verdict.

    Verdicts must be equal up to the first candidate whose MSE lies in the
    band.  With none in the band: equal structure; the card's coefficients no
    further from numpy's float64 least-squares solution than FIT_ERR_FACTOR
    times the CPU fp32 fit's (or FIT_ERR_FLOOR); and, where ``direct`` gives
    an ``(rtol, atol)``, allclose to the CPU fit's coefficients."""
    why, banded = judge_structure(card_models, cpu_models, card_log, cpu_log)
    if why is not None or banded:
        return why, {}
    cpu_coeffs = [[g.coeffs for g in m.generators] for m in cpu_models]
    dist = dict(err_card=_coeff_err(card_models, witnesses),
                err_cpu=_coeff_err(cpu_models, witnesses),
                card_vs_cpu=_coeff_err(card_models, cpu_coeffs))
    limit = max(FIT_ERR_FACTOR * dist["err_cpu"], FIT_ERR_FLOOR)
    if dist["err_card"] > limit:
        return (f"coefficients {dist['err_card']:.3g} from the float64 witness, "
                f"over the limit {limit:.3g}"), dist
    if direct is not None and not all(
            np.allclose(g.coeffs, c, rtol=direct[0], atol=direct[1])
            for m, cs in zip(card_models, cpu_coeffs) for g, c in zip(m.generators, cs)):
        return f"coefficients not allclose to the CPU fit's at {direct}", dist
    return None, dist


def compare_fits(tag, card_models, cpu_models, card_log, cpu_log, data, control,
                 direct=None):
    """Hold the card fits against the CPU fp32 fits; then report how the same
    check judges the control fits (plain ops with TF32 products)."""
    witnesses = [lstsq_coeffs(m, X) for m, X in zip(cpu_models, data)]
    why, dist = judge_fits(card_models, cpu_models, card_log, cpu_log,
                           witnesses, direct)
    if why is not None:
        raise AssertionError(f"{tag}: {why}")
    log(f"  {tag}: |O| {[m.num_O for m in card_models]} |G| "
        f"{[m.num_G for m in card_models]} equal on card and CPU; coefficients' "
        f"max distance from the float64 least-squares witness: card "
        f"{dist.get('err_card')!r}, CPU fp32 {dist.get('err_cpu')!r}; card vs CPU "
        f"{dist.get('card_vs_cpu')!r}")
    ctl_models, ctl_log = control
    ctl_why, ctl = judge_fits(ctl_models, cpu_models, ctl_log, cpu_log, witnesses,
                              direct)
    log(f"  {tag}: control fit (plain ops, TF32 products): "
        f"{ctl_why or 'passes the check'}; distances {ctl}")
    return dict(dist, control=ctl_why or "passes", control_dist=ctl)


def main_path_paper_scale():
    import torch

    from repro_torch import api
    from repro_torch.core.pipeline import PipelineConfig, VanishingIdealClassifier
    from repro_torch.data import synthetic
    from repro_torch.kernels import ops

    log("phase 3: Algorithm 2 on appendix_c(m=2_000_000), 60/40 split, psi=0.005")
    X, y = synthetic.appendix_c(m=2_000_000, seed=0)
    Xtr, ytr, Xte, yte = synthetic.train_test_split(X, y, test_frac=0.4, seed=0)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    clf, card_log = recording_fit(
        lambda: VanishingIdealClassifier(PipelineConfig(method="fast", psi=PSI)).fit(Xtr, ytr)
    )
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    feats = clf.transform(Xte)
    torch.cuda.synchronize()
    transform_s = time.perf_counter() - t1
    acc = float(np.mean(clf.head(feats) == yte))
    launches = ops.launch_counts()
    s = clf.stats
    log(f"  fit {fit_s:.3f} s (generators {s['time_generators']:.3f} s, transform "
        f"{s['time_transform']:.3f} s, svm {s['time_svm']:.3f} s, svm iters "
        f"{s['svm']['iters']}); test transform of {Xte.shape[0]} rows {transform_s:.3f} s; "
        f"accuracy {acc:.4f}")
    for c, m in zip(clf.classes_, clf.models):
        log(f"  class {c}: |O|={m.num_O} |G|={m.num_G} degrees {m.stats['degrees']} "
            f"borders {m.stats['border_sizes']} degree_times "
            f"{[round(t, 4) for t in m.stats['degree_times']]}")
    appends = sum(not a for _, _, a in card_log)
    # the classifier's default fits its classes as one batched group: one
    # launch of each kernel per degree of the group
    degrees = max(len(m.stats["degrees"]) for m in clf.models)
    log(f"  kernel launches on the main path: {launches}; one class-batched group of "
        f"{len(clf.models)} classes, {degrees} degrees, {len(card_log)} candidates, "
        f"{appends} appended")
    if s["class_batched"] != len(clf.models):
        raise AssertionError(f"{s['class_batched']} of {len(clf.models)} classes batched")
    for name in ("gram_update_acc_batched", "ihb_degree_batched"):
        if launches[name] != degrees:
            raise AssertionError(f"{name} launched {launches[name]} times, expected one "
                                 f"per degree of the group ({degrees})")
    if not (feats.shape == (Xte.shape[0], sum(m.num_G for m in clf.models))
            and np.all(np.isfinite(feats))):
        raise AssertionError("features are not finite of the expected shape")
    if acc < 0.8:
        raise AssertionError(f"accuracy {acc} below 0.8")

    Xs = clf.scaler.transform(Xtr)
    classes = [Xs[ytr == c] for c in clf.classes_]
    # the generators alone, batched (the default) beside sequential
    gen_s = {}
    for mode in ("auto", "off", "auto", "off"):
        t = time.perf_counter()
        api.fit_classes(classes, psi=PSI, class_batch=mode)
        torch.cuda.synchronize()
        gen_s.setdefault(mode, []).append(time.perf_counter() - t)
    log(f"  generators alone (api.fit_classes, fast): batched {gen_s['auto']} s, sequential "
        f"{gen_s['off']} s")
    t2 = time.perf_counter()
    cpu_models, cpu_log = recording_fit(
        lambda: api.fit_classes(classes, psi=PSI, device="cpu"))
    log(f"  the same per-class fits on the CPU: {time.perf_counter() - t2:.3f} s")
    with plain_tf32():
        control = recording_fit(lambda: api.fit_classes(classes, psi=PSI))
    check = compare_fits("paper scale", clf.models, cpu_models, card_log, cpu_log,
                         classes, control, direct=FIT_DIRECT_TOL)
    return launches, dict(fit_s=fit_s, transform_s=transform_s, accuracy=acc,
                          ihb_appends=appends, generators_batched_s=gen_s["auto"],
                          generators_sequential_s=gen_s["off"], **check), (Xtr, ytr, Xte, yte), clf


def main_path_wide():
    import torch

    from repro_torch import api
    from repro_torch.core.transform import MinMaxScaler
    from repro_torch.data import synthetic
    from repro_torch.kernels import ops

    log("phase 4: api.fit on class 0 of uci_like('spam') (n=57), psi=0.005")
    X, y = synthetic.uci_like("spam", seed=0)
    X0 = MinMaxScaler(dtype="float32").fit_transform(X)[y == 0]
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    card, card_log = recording_fit(lambda: api.fit(X0, "oavi", psi=PSI))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    st = card.stats
    appends = sum(not a for _, _, a in card_log)
    log(f"  m={X0.shape[0]} fit {fit_s:.3f} s; borders {st['border_sizes']}; "
        f"Lcap {st['Lcap_final']} after {st['regrowths']} regrowths; degree_times "
        f"{st['degree_times']}; launches {launches}; {len(card_log)} candidates, "
        f"{appends} appended")
    if st["Lcap_final"] != 2048:
        raise AssertionError(f"expected Lcap 2048, got {st['Lcap_final']}")
    for name in ("gram_update_acc", "ihb_degree"):
        if launches[name] <= 0:
            raise AssertionError(f"wide path did not launch {name}")
    if launches["ihb_degree"] != len(st["degrees"]):
        raise AssertionError(f"ihb_degree launched {launches['ihb_degree']} times, "
                             f"expected one per degree")
    # the device's busy share and its time by kernel over one wide fit
    prof = profile_device("wide fit", lambda: api.fit(X0, "oavi", psi=PSI))
    feats = card.transform(X0)
    if not np.all(np.isfinite(feats)):
        raise AssertionError("wide-fit features are not finite")
    t1 = time.perf_counter()
    cpu, cpu_log = recording_fit(lambda: api.fit(X0, "oavi", psi=PSI, device="cpu"))
    log(f"  the same fit on the CPU: {time.perf_counter() - t1:.3f} s")
    with plain_tf32():
        ctl, ctl_log = recording_fit(lambda: api.fit(X0, "oavi", psi=PSI))
    check = compare_fits("wide", [card], [cpu], card_log, cpu_log, [X0],
                         ([ctl], ctl_log))
    return launches, dict(fit_s=fit_s, degree_times=st["degree_times"],
                          ihb_appends=appends, profile=prof, **check), (X0, card, card_log)


# ---------------------------------------------------------------------------
# Phase 5: flash attention
# ---------------------------------------------------------------------------


def check_flash(dev, tag, B, Hq, Hkv, Sq, Sk, d, dv, causal, reps):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import flash_attention, variant

    gen = torch.Generator(device=dev)
    gen.manual_seed(Sq * 31 + Sk + d)

    def draw(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    q, k, v = draw(B * Hq, Sq, d), draw(B * Hkv, Sk, d), draw(B * Hkv, Sk, dv)
    group = Hq // Hkv
    got = ops.multihead_attention(q.view(B, Hq, Sq, d), k.view(B, Hkv, Sk, d),
                                  v.view(B, Hkv, Sk, dv), causal=causal)
    got = got.reshape(B * Hq, Sq, dv)
    want = ref.attention_ref(q.float(), k.float(), v.float(), causal=causal,
                             q_heads_per_kv=group)
    plain_bf16 = ref.attention_ref(q, k, v, causal=causal, q_heads_per_kv=group)
    torch.cuda.synchronize()
    kind = variant(q.dtype, d, dv)
    name = (f"flash_attention {tag}: (B*Hq, Sq, d)=({B * Hq}, {Sq}, {d}), Sk={Sk}, dv={dv}, "
            f"group {group}, causal={causal}, {kind} variant")
    err = check_close(name, got.float(), want, FLASH_TOL, FLASH_TOL)
    plain_err = float((plain_bf16.float() - want).abs().max())
    log(f"  {name}: the bf16 plain version's own max_abs_err {plain_err:.6g}")
    del want, plain_bf16

    def library():
        return F.scaled_dot_product_attention(
            q.view(B, Hq, Sq, d), k.view(B, Hkv, Sk, d), v.view(B, Hkv, Sk, dv),
            is_causal=causal, enable_gqa=group > 1)

    ms = time_ms(lambda: flash_attention(q, k, v, causal=causal, q_heads_per_kv=group), reps)
    plain_ms = time_ms(lambda: ref.attention_ref(q, k, v, causal=causal,
                                                 q_heads_per_kv=group), max(1, reps // 10))
    try:
        lib_ms = time_ms(library, reps)
    except RuntimeError as exc:  # no SDPA backend takes these shapes
        log(f"  {name}: scaled_dot_product_attention refused: {exc}")
        lib_ms = None
    pairs = Sq * (Sq + 1) // 2 if causal else Sq * Sk
    flops = 2.0 * (d + dv) * B * Hq * pairs
    nbytes = 2.0 * (B * Hq * Sq * (d + dv) + B * Hkv * Sk * (d + dv))
    b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    log(f"  {name}: kernel {ms:.4f} ms ({rate_note(flops, ms, b_ms)}), plain {plain_ms:.4f} ms, "
        f"library (sdpa) {lib_ms if lib_ms is None else f'{lib_ms:.4f}'} ms, bound "
        f"{b_ms:.4f} ms ({b_by}: {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, plain_bf16_max_abs_err=plain_err, variant=kind,
                shape=dict(BHq=B * Hq, Sq=Sq, Sk=Sk, d=d, dv=dv, group=group, causal=causal))


# ---------------------------------------------------------------------------
# Phase 6: LM serving at full width
# ---------------------------------------------------------------------------


def _logit_dists(kernel, plain, fp32):
    import torch

    k, p, w = kernel.float(), plain.float(), fp32.float()
    return dict(kernel_vs_plain=float((k - p).abs().max()),
                kernel_vs_fp32=float((k - w).abs().max()),
                plain_vs_fp32=float((p - w).abs().max()),
                logit_std=float(w.std()),
                top1_equal=bool(torch.equal(k.argmax(-1), p.argmax(-1))))


def judge_logits(tag, dists):
    limit = LM_FACTOR * dists["plain_vs_fp32"]
    log(f"  {tag}: max |logit| distance kernel vs plain {dists['kernel_vs_plain']:.6g}, "
        f"kernel vs fp32 {dists['kernel_vs_fp32']:.6g}, plain bf16 vs fp32 "
        f"{dists['plain_vs_fp32']:.6g} (limit {limit:.6g}); fp32 logit std "
        f"{dists['logit_std']:.6g}; same top-1 token: {dists['top1_equal']}")
    if dists["kernel_vs_fp32"] > limit or dists["kernel_vs_plain"] > limit:
        raise AssertionError(f"{tag}: the kernel model's logits are off")


def main_path_serve(dev):
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.models.model import Transformer

    cfg = configs.get_config("qwen3-8b")
    batch, prompt_len, gen_tokens = 4, 2048, 32
    n_attn = cfg.n_periods * cfg.period.count("attn")
    log(f"phase 6: serve {cfg.name} at full width ({cfg.n_periods} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, {cfg.dtype}), batch {batch}, prompt {prompt_len}, "
        f"{gen_tokens} generated tokens, seed 0")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = serve(cfg, batch=batch, prompt_len=prompt_len, gen_tokens=gen_tokens, seed=0)
    serve_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    gen = out["generated"]
    log(f"  serve: {serve_s:.3f} s in all (init included); prefill {out['prefill_s']:.4f} s "
        f"({batch * prompt_len / out['prefill_s']:.1f} prompt tokens/s); decode "
        f"{out['decode_s']:.4f} s for {gen_tokens - 1} steps, {out['tokens_per_s']:.2f} "
        f"tokens/s; peak memory {peak_gb:.2f} GB; kernel launches {launches}")
    if launches["flash_attention"] != n_attn:
        raise AssertionError(f"prefill launched flash_attention {launches['flash_attention']} "
                             f"times, expected {n_attn}")
    if gen.shape != (batch, gen_tokens) or gen.min() < 0 or gen.max() >= cfg.vocab_size:
        raise AssertionError(f"generated tokens {gen.shape} out of range")

    model = Transformer(cfg, device=dev, seed=0)
    prompts = torch.as_tensor(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (batch, prompt_len)),
        dtype=torch.long, device=dev)
    S_max = prompt_len + gen_tokens
    pos = torch.full((batch,), prompt_len, dtype=torch.long, device=dev)
    with torch.inference_mode():
        lk, ck = model.prefill(prompts, S_max)
        tok = lk[:, -1].argmax(-1)
        log(f"  the same weights rebuilt from seed 0: first generated tokens "
            f"{tok.tolist()}, serve gave {gen[:, 0].tolist()}")
        dk, _ = model.decode_step(ck, tok, pos)
        # the device's busy time by kernel in one prefill and one decode step
        prof = {"prefill": profile_device("prefill", lambda: model.prefill(prompts, S_max)),
                "decode": profile_device("decode step", lambda: model.decode_step(ck, tok, pos))}
        del ck
        lp, cp = model.prefill(prompts, S_max, use_kernel=False)
        dp, _ = model.decode_step(cp, tok, pos)
        del cp
        model32 = Transformer.from_params(dataclasses.replace(cfg, dtype="float32"),
                                          model.state_dict(), device=dev)
        del model
        l32, c32 = model32.prefill(prompts, S_max, use_kernel=False)
        d32, _ = model32.decode_step(c32, tok, pos)
        del c32, model32
    pre = _logit_dists(lk[:, -1], lp[:, -1], l32[:, -1])
    dec = _logit_dists(dk[:, 0], dp[:, 0], d32[:, 0])
    for tag, dists, t in (("prefill last-token logits", pre, lk),
                          ("teacher-forced decode logits", dec, dk)):
        if t.shape[-1] != cfg.vocab_size or not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{tag}: not finite of width {cfg.vocab_size}")
        judge_logits(tag, dists)
    torch.cuda.empty_cache()
    return launches, dict(prefill_s=out["prefill_s"], decode_s=out["decode_s"],
                          tokens_per_s=out["tokens_per_s"], serve_s=serve_s,
                          peak_memory_gb=peak_gb, prefill_logits=pre, decode_logits=dec,
                          profile=prof)


# ---------------------------------------------------------------------------
# Phase 7: the paper's oracle variants
# ---------------------------------------------------------------------------

ORACLE_VARIANTS = ("cgavi-ihb", "agdavi-ihb", "bpcgavi-wihb", "bpcgavi", "pcgavi",
                   "cgavi", "agdavi")
IHB_WARM = ("cgavi-ihb", "agdavi-ihb", "bpcgavi-wihb")  # keep N: one update a candidate
# PCG and BPCG choose their away and local vertices by argmax over scores that
# tie to ~1e-6 relative; fp32 sums in another order (card vs CPU) round such
# a near-tie either way and the runs then take different, equally valid
# paths (tests/test_torch_oracles.py), each stopping at the first iterate
# whose MSE is at most psi.  Their coefficients are held by that promise:
# every generator's MSE on its data at most psi * (1 + VANISH_SLACK), the
# rule tests/test_oavi.py holds the reference's generators to.
SPLITTING = ("bpcgavi-wihb", "bpcgavi", "pcgavi")
VANISH_SLACK = 1e-3


def judge_oracle_fits(variant, card_models, cpu_models, card_log, cpu_log, data):
    """Hold one variant's card fits against its CPU fits: the verdicts and
    structure as ``judge_fits`` holds them; coefficients by the float64
    witness rule (CG, AGD and the IHB-warm CG/AGD variants) or by the
    vanishing rule (PCG and BPCG).  Returns the distances logged."""
    if variant not in SPLITTING:
        witnesses = [lstsq_coeffs(m, X) for m, X in zip(cpu_models, data)]
        why, dist = judge_fits(card_models, cpu_models, card_log, cpu_log,
                               witnesses, None)
        if why is not None:
            raise AssertionError(f"{variant}: {why}")
        return dist
    why, banded = judge_structure(card_models, cpu_models, card_log, cpu_log)
    if why is not None:
        raise AssertionError(f"{variant}: {why}")
    mse = max(float(m.mse(X).max()) for m, X in zip(card_models, data))
    if mse > PSI * (1 + VANISH_SLACK):
        raise AssertionError(f"{variant}: a card generator's MSE {mse!r} exceeds psi")
    if banded:
        return dict(max_card_mse=mse)
    cpu_coeffs = [[g.coeffs for g in m.generators] for m in cpu_models]
    return dict(max_card_mse=mse, card_vs_cpu=_coeff_err(card_models, cpu_coeffs))


def main_path_oracles(paper_data, wide_fast):
    import shutil

    import torch

    from repro_torch import api
    from repro_torch.core.pipeline import PipelineConfig, VanishingIdealClassifier
    from repro_torch.core.transform import MinMaxScaler
    from repro_torch.kernels import ops

    log("phase 7: the paper's oracle variants on appendix_c(m=2_000_000), 60/40 split, "
        "psi=0.005")
    Xtr, ytr, Xte, yte = paper_data
    Xs = MinMaxScaler(dtype="float32").fit_transform(Xtr)
    labels = np.unique(ytr)
    classes = [Xs[ytr == c] for c in labels]
    out, launches_all = {}, {}
    for v in ORACLE_VARIANTS:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        card, card_log = recording_fit(lambda: api.fit_classes(classes, f"oavi:{v}", psi=PSI,
                                                               class_batch="off"))
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = ops.launch_counts()
        t1 = time.perf_counter()
        cpu, cpu_log = recording_fit(
            lambda: api.fit_classes(classes, f"oavi:{v}", psi=PSI, class_batch="off",
                                    device="cpu"))
        cpu_s = time.perf_counter() - t1
        dist = judge_oracle_fits(v, card, cpu, card_log, cpu_log, classes)
        degrees = sum(len(m.stats["degrees"]) for m in card)
        want_single = len(card_log) if v in IHB_WARM else 0
        if launches["gram_update_acc"] != degrees or launches["ihb_degree"] != 0:
            raise AssertionError(f"{v}: launches {launches}, expected one Gram launch "
                                 f"per degree ({degrees}) and no ihb_degree")
        if launches["ihb_update"] != want_single:
            raise AssertionError(f"{v}: {launches['ihb_update']} ihb_update launches, "
                                 f"expected {want_single} (one per candidate)")
        iters = [m.stats["solver_iters"] for m in card]
        reads = [m.stats["host_reads"] for m in card]
        log(f"  {v}: card fit {fit_s:.3f} s (CPU {cpu_s:.3f} s); solver_iters card "
            f"{iters}, CPU {[m.stats['solver_iters'] for m in cpu]}; host reads {reads}; "
            f"{len(card_log)} candidates, {sum(not a for _, _, a in card_log)} appended; "
            f"launches {launches}; |O| {[m.num_O for m in card]} |G| "
            f"{[m.num_G for m in card]} equal on card and CPU; {dist}")
        launches_all[v] = launches
        out[v] = dict(fit_s=fit_s, cpu_fit_s=cpu_s, solver_iters=iters, host_reads=reads,
                      candidates=len(card_log), launches=launches, **dist)

    # the device's view of one CGAVI-IHB per-class fit
    out["cgavi-ihb"]["profile_class0"] = profile_device(
        "cgavi-ihb fit of class 0", lambda: api.fit(classes[0], "oavi:cgavi-ihb", psi=PSI),
        watch=("ihb_update_kernel",))

    # Algorithm 2 with the paper's method, saved and loaded on the card
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    clf = VanishingIdealClassifier(PipelineConfig(method="cgavi-ihb", psi=PSI)).fit(Xtr, ytr)
    torch.cuda.synchronize()
    clf_s = time.perf_counter() - t0
    clf_launches = ops.launch_counts()
    pred = clf.predict(Xte)
    acc = float(np.mean(pred == yte))
    s = clf.stats
    log(f"  classifier (cgavi-ihb): fit {clf_s:.3f} s (generators {s['time_generators']:.3f} s, "
        f"transform {s['time_transform']:.3f} s, svm {s['time_svm']:.3f} s); accuracy "
        f"{acc:.4f}; launches {clf_launches}")
    if acc < 0.8:
        raise AssertionError(f"cgavi-ihb classifier accuracy {acc} below 0.8")
    if clf_launches["ihb_update_batched"] <= 0 or clf.stats["class_batched"] != len(labels):
        raise AssertionError("the cgavi-ihb classifier did not run class-batched")
    ckpt = os.path.join(HERE, "build", "chip_smoke_classifier")
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        t1 = time.perf_counter()
        clf.save(ckpt)
        save_s = time.perf_counter() - t1
        t2 = time.perf_counter()
        again = VanishingIdealClassifier.load(ckpt)
        load_s = time.perf_counter() - t2
        pred2 = again.predict(Xte)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    if again.device.type != "cuda":
        raise AssertionError(f"the classifier was loaded onto {again.device}, not the card")
    if not np.array_equal(pred2, pred):
        raise AssertionError("the loaded classifier's labels differ from the saved one's")
    log(f"  saved in {save_s:.3f} s, loaded into a fresh classifier on {again.device} in "
        f"{load_s:.3f} s: {len(pred2)} labels identical")

    # wide: CGAVI-IHB on the phase-4 data, against the phase-4 fast fit
    X0, fast, fast_log = wide_fast
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    wide, wide_log = recording_fit(lambda: api.fit(X0, "oavi:cgavi-ihb", psi=PSI))
    torch.cuda.synchronize()
    wide_s = time.perf_counter() - t0
    wide_launches = ops.launch_counts()
    st = wide.stats
    log(f"  wide cgavi-ihb: m={X0.shape[0]} fit {wide_s:.3f} s; borders {st['border_sizes']}; "
        f"Lcap {st['Lcap_final']}; degree_times {st['degree_times']}; solver_iters "
        f"{st['solver_iters']}; host reads {st['host_reads']}; launches {wide_launches}")
    if wide_launches["ihb_update"] <= 0:
        raise AssertionError("the wide cgavi-ihb fit launched no ihb_update")
    why, _ = judge_structure([wide], [fast], wide_log, fast_log)
    if why is not None:
        raise AssertionError(f"wide cgavi-ihb against the fast engine's fit: {why}")
    if not np.all(np.isfinite(wide.transform(X0))):
        raise AssertionError("wide cgavi-ihb features are not finite")
    log(f"  wide cgavi-ihb: |O| {wide.num_O} |G| {wide.num_G}, verdicts equal to the fast "
        f"engine's")
    out["classifier"] = dict(fit_s=clf_s, accuracy=acc, launches=clf_launches,
                             save_s=save_s, load_s=load_s, svm=s["svm"],
                             time_generators=s["time_generators"])
    out["wide_cgavi_ihb"] = dict(fit_s=wide_s, solver_iters=st["solver_iters"],
                                 host_reads=st["host_reads"], launches=wide_launches,
                                 degree_times=st["degree_times"])
    return launches_all["cgavi-ihb"], out


# ---------------------------------------------------------------------------
# Phase 8: the paper's baselines (Table 3)
# ---------------------------------------------------------------------------

# VCA on the card against the CPU: both fit in float64 (cuSOLVER's SVD against
# LAPACK's) and evaluate in fp32, so |G(Z)| agrees to fp32 rounding; the CPU
# parity tests hold the port to the JAX package at the same tolerance
VCA_TOL = (1e-4, 1e-6)
# classifier labels are compared on the rows whose CPU decision margin (top
# score less the runner-up) exceeds this: the card's and the CPU's SVM heads
# are fitted on features that differ by fp32 rounding
LABEL_MARGIN = 1e-3
# the polynomial-kernel SVM's CPU check runs its first iterations only (each
# iteration streams the 2.4 GB kernel matrix twice: ~0.3 s on the host, and
# the row may take up to 10,000); decision values within POLY_TOL (rtol, atol
# times the largest |value|) of the CPU's.  The same fp32 products summed in
# another order over 4,096 anchors move a value by ~1e-7 relative per step;
# TF32 products (inputs rounded to 10 bits) moved them by 3.2e-4 on values
# up to 1.7 on an H100, and a control run with TF32 must fail this tolerance.
POLY_CUT_ITERS = 64
POLY_TOL = (1e-5, 1e-5)


def vca_counts(model):
    return [model.deg1_num_vanishing] + [(b.num_vanishing, b.num_nonvanishing)
                                         for b in model.blocks]


def judge_vca(tag, card_models, cpu_models, Zs):
    """Equal counts per degree, and |G(Z)| allclose at VCA_TOL on each
    model's ``Z``; returns the largest difference."""
    if [vca_counts(m) for m in card_models] != [vca_counts(m) for m in cpu_models]:
        raise AssertionError(f"{tag}: VCA counts per degree differ: card "
                             f"{[vca_counts(m) for m in card_models]}, CPU "
                             f"{[vca_counts(m) for m in cpu_models]}")
    worst = 0.0
    for a, b, Z in zip(card_models, cpu_models, Zs):
        ga, gb = a.transform(Z), b.transform(Z)
        if not np.allclose(ga, gb, rtol=VCA_TOL[0], atol=VCA_TOL[1]):
            raise AssertionError(f"{tag}: |G(Z)| of card and CPU differ by "
                                 f"{float(np.abs(ga - gb).max())!r}")
        worst = max(worst, float(np.abs(ga - gb).max()) if ga.size else 0.0)
    return worst


def clear_labels_agree(tag, card_labels, cpu_scores, classes):
    """The card's labels equal the CPU's on every row whose CPU decision
    margin exceeds LABEL_MARGIN; returns (rows outside it, disagreements)."""
    top2 = np.sort(cpu_scores, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > LABEL_MARGIN
    cpu_labels = classes[np.argmax(cpu_scores, axis=1)]
    if not np.array_equal(card_labels[clear], cpu_labels[clear]):
        bad = int(np.sum(card_labels[clear] != cpu_labels[clear]))
        raise AssertionError(f"{tag}: {bad} labels differ from the CPU's on clear rows")
    return int((~clear).sum()), int(np.sum(card_labels != cpu_labels))


def main_path_baselines(dev, paper_data, wide_X0):
    import shutil

    import torch

    from repro_torch import api
    from repro_torch.core import abm
    from repro_torch.core.pipeline import PipelineConfig, VanishingIdealClassifier
    from repro_torch.core.svm import PolySVM, PolySVMConfig
    from repro_torch.core.transform import MinMaxScaler
    from repro_torch.data import synthetic
    from repro_torch.kernels import ops

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 products are on; the baselines run in full fp32")
    out = {}
    log("phase 8a: ABM and VCA on appendix_c(m=2_000_000), 60/40 split, psi=0.005")
    Xtr, ytr, Xte, _ = paper_data
    scaler = MinMaxScaler(dtype="float32").fit(Xtr)
    Xs = scaler.transform(Xtr)
    labels = np.unique(ytr)
    classes = [Xs[ytr == c] for c in labels]
    Zte = scaler.transform(Xte[:10_000])

    # ABM: kernel 3 on the card, one launch per degree
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    card, card_log = recording_fit(
        lambda: api.fit_classes(classes, "abm", psi=PSI, cap_terms=64), module=abm)
    torch.cuda.synchronize()
    abm_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    t1 = time.perf_counter()
    cpu, cpu_log = recording_fit(
        lambda: api.fit_classes(classes, "abm", psi=PSI, cap_terms=64, device="cpu"),
        module=abm)
    abm_cpu_s = time.perf_counter() - t1
    degrees = sum(len(m.stats["degrees"]) for m in card)
    eighs = sum(m.stats["eigh_calls"] for m in card)
    if launches["gram_update"] != degrees or sum(launches.values()) != degrees:
        raise AssertionError(f"ABM launches {launches}, expected gram_update once per "
                             f"degree ({degrees}) and nothing else")
    witnesses = [abm_witness(m, X) for m, X in zip(cpu, classes)]
    why, dist = judge_fits(card, cpu, card_log, cpu_log, witnesses, None)
    if why is not None:
        raise AssertionError(f"ABM at paper scale: {why}")
    margin = min(abs(mse - PSI) for _, mse, _ in cpu_log) / PSI
    log(f"  ABM: card {abm_s:.3f} s (CPU {abm_cpu_s:.3f} s); borders "
        f"{[m.stats['border_sizes'] for m in card]}; |O| {[m.num_O for m in card]} |G| "
        f"{[m.num_G for m in card]} equal on card and CPU; gram_update launches "
        f"{launches['gram_update']}, eigh calls {eighs}; nearest eigenvalue {margin:.4f} "
        f"psi from psi; coefficients' distance from the float64 eigenvector witness: card "
        f"{dist.get('err_card')!r}, CPU {dist.get('err_cpu')!r}, card vs CPU "
        f"{dist.get('card_vs_cpu')!r}")
    gram3 = check_gram_update(dev, classes[0].shape[0], 64, 3, 64, reps=10)
    prof = profile_device("ABM fit of class 0",
                          lambda: api.fit(classes[0], "abm", psi=PSI, cap_terms=64),
                          watch=("gram",))
    out["abm"] = dict(fit_s=abm_s, cpu_fit_s=abm_cpu_s, launches=launches,
                      eigh_calls=eighs, degrees=degrees, margin_psi=margin,
                      profile_class0=prof, **dist)

    # VCA: one SVD a degree on the card
    t0 = time.perf_counter()
    vcard = api.fit_classes(classes, "vca", psi=PSI)
    torch.cuda.synchronize()
    vca_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    vcpu = api.fit_classes(classes, "vca", psi=PSI, device="cpu")
    vca_cpu_s = time.perf_counter() - t1
    worst = judge_vca("VCA at paper scale", vcard, vcpu, [Zte] * len(vcard))
    svd = [m.stats["svd_times"] for m in vcard]
    log(f"  VCA: card {vca_s:.3f} s (CPU {vca_cpu_s:.3f} s); counts per degree "
        f"{[vca_counts(m) for m in vcard]} equal on card and CPU; SVD seconds {svd} "
        f"(CPU {[m.stats['svd_times'] for m in vcpu]}); |G| of {Zte.shape[0]} test rows "
        f"within {worst:.3g} of the CPU's")
    out["vca"] = dict(fit_s=vca_s, cpu_fit_s=vca_cpu_s, svd_s=svd,
                      counts=[vca_counts(m) for m in vcard], max_abs_err=worst)

    log("phase 8b: Table 3 on uci_like('skin') (245,057 x 3), 60/40 split, psi=0.005")
    X, y = synthetic.uci_like("skin", seed=0)
    Str, sytr, Ste, syte = synthetic.train_test_split(X, y, test_frac=0.4, seed=0)
    rows = {}
    for method, kw in (("abm", {"cap_terms": 64}), ("vca", {})):
        cfg = PipelineConfig(method=method, psi=PSI, oavi_kw=kw)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        clf = VanishingIdealClassifier(cfg).fit(Str, sytr)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        row_launches = ops.launch_counts()
        t1 = time.perf_counter()
        pred = clf.predict(Ste)
        test_s = time.perf_counter() - t1
        t2 = time.perf_counter()
        ref = VanishingIdealClassifier(cfg, device="cpu").fit(Str, sytr)
        cpu_s = time.perf_counter() - t2
        unclear, differ = clear_labels_agree(
            f"skin {method}", pred, ref.svm.decision_function(ref.transform(Ste)),
            ref.classes_)
        s = clf.stats
        row = dict(err_test_pct=100.0 * float(np.mean(pred != syte)), fit_s=fit_s,
                   time_generators=s["time_generators"], time_transform=s["time_transform"],
                   time_svm=s["time_svm"], svm_iters=s["svm"]["iters"], test_s=test_s,
                   G_plus_O=s["G_plus_O"], avg_degree=clf.average_degree(),
                   spar=clf.sparsity(), cpu_fit_s=cpu_s, unclear_rows=unclear,
                   labels_differing=differ, launches=row_launches)
        if method == "abm" and row_launches["gram_update"] <= 0:
            raise AssertionError("the skin ABM classifier launched no gram_update")
        log(f"  {method}: test error {row['err_test_pct']:.3f}%; fit {fit_s:.3f} s "
            f"(generators {s['time_generators']:.3f}, transform {s['time_transform']:.3f}, "
            f"svm {s['time_svm']:.3f} s, {s['svm']['iters']} iterations); test {test_s:.3f} s; "
            f"G+O {s['G_plus_O']}; average degree {row['avg_degree']:.3f}; SPAR "
            f"{row['spar']:.3f}; launches {row_launches}; CPU fit {cpu_s:.3f} s, labels equal "
            f"on clear rows ({unclear} within {LABEL_MARGIN} of a tie, {differ} differ)")
        if method == "vca":
            ckpt = os.path.join(HERE, "build", "chip_smoke_vca_classifier")
            shutil.rmtree(ckpt, ignore_errors=True)
            try:
                t3 = time.perf_counter()
                clf.save(ckpt)
                row["save_s"] = time.perf_counter() - t3
                t4 = time.perf_counter()
                again = VanishingIdealClassifier.load(ckpt)
                row["load_s"] = time.perf_counter() - t4
                pred2 = again.predict(Ste)
            finally:
                shutil.rmtree(ckpt, ignore_errors=True)
            if any(m.device.type != "cuda" for m in again.models):
                raise AssertionError("the VCA classifier was not loaded onto the card")
            if not np.array_equal(pred2, pred):
                raise AssertionError("the loaded VCA classifier's labels differ")
            log(f"  vca: saved in {row['save_s']:.3f} s, loaded on the card in "
                f"{row['load_s']:.3f} s: {len(pred2)} labels identical")
        rows[method] = row

    pcfg = PolySVMConfig(degree=3, lam=1e-4)
    t0 = time.perf_counter()
    poly = PolySVM(pcfg).fit(Str, sytr)
    torch.cuda.synchronize()
    poly_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    ppred = poly.predict(Ste)
    ptest_s = time.perf_counter() - t1
    K_bytes = 4 * Str.shape[0] * poly.anchors.shape[0]
    log(f"  poly-svm: test error {100.0 * float(np.mean(ppred != syte)):.3f}%; fit {poly_s:.3f} s "
        f"({poly.stats['iters']} iterations, cross-kernel {Str.shape[0]} x "
        f"{poly.anchors.shape[0]} fp32 = {K_bytes / 1e9:.2f} GB); test {ptest_s:.3f} s; "
        f"G+O 0; average degree 3; SPAR 0")
    cut = dataclasses.replace(pcfg, max_iter=POLY_CUT_ITERS)
    card_cut = PolySVM(cut).fit(Str, sytr)
    t2 = time.perf_counter()
    cpu_cut = PolySVM(cut, device="cpu").fit(Str, sytr)
    cut_cpu_s = time.perf_counter() - t2
    d_card = card_cut.decision_function(Ste)
    d_cpu = cpu_cut.decision_function(Ste)
    scale = float(np.abs(d_cpu).max())
    if not (np.array_equal(card_cut.anchors, cpu_cut.anchors)
            and card_cut.stats == cpu_cut.stats):
        raise AssertionError(f"poly-svm: anchors or stats differ from the CPU's "
                             f"({card_cut.stats} vs {cpu_cut.stats})")
    if not np.allclose(d_card, d_cpu, rtol=POLY_TOL[0], atol=POLY_TOL[1] * scale):
        raise AssertionError(f"poly-svm: decision values differ from the CPU's by "
                             f"{float(np.abs(d_card - d_cpu).max())!r}")
    unclear, differ = clear_labels_agree("skin poly-svm", card_cut.classes_[
        np.argmax(d_card, axis=1)], d_cpu, cpu_cut.classes_)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        d_tf32 = PolySVM(cut).fit(Str, sytr).decision_function(Ste)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    tf32_ok = bool(np.allclose(d_tf32, d_cpu, rtol=POLY_TOL[0], atol=POLY_TOL[1] * scale))
    if tf32_ok:
        raise AssertionError("poly-svm: the tolerance does not tell TF32 from fp32")
    log(f"  poly-svm, first {POLY_CUT_ITERS} iterations on card and CPU ({cut_cpu_s:.3f} s): "
        f"same anchors, decision values within {float(np.abs(d_card - d_cpu).max()):.3g} "
        f"(largest |value| {scale:.3g}); labels equal on clear rows ({unclear} within "
        f"{LABEL_MARGIN} of a tie, {differ} differ); control with TF32 products: "
        f"{float(np.abs(d_tf32 - d_cpu).max()):.3g} from the CPU's, within tolerance: "
        f"{tf32_ok}")
    rows["poly-svm"] = dict(err_test_pct=100.0 * float(np.mean(ppred != syte)), fit_s=poly_s,
                            iters=poly.stats["iters"], test_s=ptest_s, kernel_gb=K_bytes / 1e9,
                            cut_max_abs_err=float(np.abs(d_card - d_cpu).max()),
                            cut_cpu_s=cut_cpu_s, tf32_control_within_tolerance=tf32_ok,
                            G_plus_O=0, avg_degree=3.0, spar=0.0)
    out["skin_table3"] = rows

    log("phase 8c: VCA on class 0 of uci_like('spam') (n=57), psi=0.005")
    t0 = time.perf_counter()
    wide = api.fit(wide_X0, "vca", psi=PSI)
    torch.cuda.synchronize()
    wide_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    wide_cpu = api.fit(wide_X0, "vca", psi=PSI, device="cpu")
    wide_cpu_s = time.perf_counter() - t1
    worst = judge_vca("wide VCA", [wide], [wide_cpu], [wide_X0])
    log(f"  m={wide_X0.shape[0]}: card {wide_s:.3f} s (CPU {wide_cpu_s:.3f} s); borders "
        f"{wide.stats['border_sizes']}; counts per degree {vca_counts(wide)} equal on card "
        f"and CPU; |G| = {wide.num_G}; SVD seconds {wide.stats['svd_times']} (CPU "
        f"{wide_cpu.stats['svd_times']}); |G| of the training rows within {worst:.3g}")
    out["wide_vca"] = dict(fit_s=wide_s, cpu_fit_s=wide_cpu_s, svd_s=wide.stats["svd_times"],
                           cpu_svd_s=wide_cpu.stats["svd_times"], num_G=wide.num_G,
                           max_abs_err=worst)
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 products were left on")
    return launches, gram3, out


# ---------------------------------------------------------------------------
# Phase 9: class-batched OAVI, the default multi-class fit
# ---------------------------------------------------------------------------


def _bit_equal_models(tag, bat, seq):
    for c, (b, q) in enumerate(zip(bat, seq)):
        if not (b.book.terms == q.book.terms
                and [g.term for g in b.generators] == [g.term for g in q.generators]
                and all(np.array_equal(gb.coeffs, gq.coeffs) and gb.mse == gq.mse
                        for gb, gq in zip(b.generators, q.generators))):
            raise AssertionError(f"{tag}: class {c}: batched fit differs from the sequential fit")


def batched_vs_sequential(tag, classes, spec, config=None):
    """One class-batched ``api.fit_classes`` on the card (the main path:
    counts reset before, read after) and the same classes fitted one after
    another on the card: the models must be equal bit for bit.  Returns the
    batched models, their log, the launches, and both fits' seconds."""
    import torch

    from repro_torch import api
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    bat, bat_log = recording_fit(lambda: api.fit_classes(classes, spec, psi=PSI,
                                                         config=config))
    torch.cuda.synchronize()
    bat_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    t1 = time.perf_counter()
    seq = api.fit_classes(classes, spec, psi=PSI, config=config, class_batch="off")
    torch.cuda.synchronize()
    seq_s = time.perf_counter() - t1
    _bit_equal_models(tag, bat, seq)
    agg = api.aggregate_fit_stats(bat)
    groups = agg["class_batch_groups"]
    log(f"  {tag}: batched {bat_s:.3f} s, sequential {seq_s:.3f} s, bit-identical; "
        f"{groups} group(s), escalations {agg['solver_escalations']}, schedule "
        f"{agg['solver_schedule_len']}, padding {agg.get('class_batch_padding')}; launches "
        f"{launches}")
    if agg["class_batched"] != len(classes):
        raise AssertionError(f"{tag}: {agg['class_batched']} of {len(classes)} classes batched")
    if launches["gram_update_acc"] or launches["ihb_degree"] or launches["ihb_update"]:
        raise AssertionError(f"{tag}: a one-class kernel entry ran on the batched path")
    return bat, bat_log, launches, dict(batched_s=bat_s, sequential_s=seq_s, groups=groups,
                                        escalations=agg["solver_escalations"],
                                        schedule=agg["solver_schedule_len"],
                                        padding=agg.get("class_batch_padding"),
                                        launches=launches)


def main_path_class_batch(paper_data):
    import torch

    from repro_torch import api
    from repro_torch.core import class_batch
    from repro_torch.core.oavi import OAVIConfig
    from repro_torch.core.oracles import OracleConfig
    from repro_torch.core.transform import MinMaxScaler
    from repro_torch.data import synthetic

    out = {}
    log("phase 9a: class-batched api.fit_classes on appendix_c(m=2_000_000), 60/40 split, "
        "psi=0.005")
    Xtr, ytr = paper_data[0], paper_data[1]
    Xs = MinMaxScaler(dtype="float32").fit_transform(Xtr)
    classes = [Xs[ytr == c] for c in np.unique(ytr)]
    launches_by_path = {}
    for v in ("fast", "cgavi-ihb"):
        bat, bat_log, launches, rec = batched_vs_sequential(f"9a {v}", classes, f"oavi:{v}")
        degrees = max(len(m.stats["degrees"]) for m in bat)
        mc = bat[0].stats["class_batch"]["m_cap"]
        A_bytes = len(classes) * mc * bat[0].stats["Lcap_final"] * 4
        if launches["gram_update_acc_batched"] != degrees:
            raise AssertionError(f"9a {v}: {launches['gram_update_acc_batched']} Gram launches, "
                                 f"expected one per degree of the group ({degrees})")
        if v == "fast" and launches["ihb_degree_batched"] != degrees:
            raise AssertionError(f"9a fast: ihb_degree_batched launched "
                                 f"{launches['ihb_degree_batched']} times, expected {degrees}")
        if v == "cgavi-ihb" and launches["ihb_update_batched"] <= 0:
            raise AssertionError("9a cgavi-ihb: no batched ihb_update launch")
        t0 = time.perf_counter()
        cpu, cpu_log = recording_fit(lambda: api.fit_classes(classes, f"oavi:{v}", psi=PSI,
                                                             device="cpu"))
        cpu_s = time.perf_counter() - t0
        dist = judge_oracle_fits(v, bat, cpu, bat_log, cpu_log, classes)
        log(f"  9a {v}: m_cap {mc}, A {A_bytes / 2**20:.0f} MiB; {degrees} degrees: "
            f"gram_update_acc_batched x{launches['gram_update_acc_batched']}, "
            f"ihb_degree_batched x{launches['ihb_degree_batched']}, ihb_update_batched "
            f"x{launches['ihb_update_batched']}; per fit kernel_launches "
            f"{bat[0].stats['kernel_launches']}; CPU fit {cpu_s:.3f} s, held by the "
            f"float64 witness: {dist}")
        launches_by_path[v] = launches
        out[f"9a_{v}"] = dict(rec, cpu_s=cpu_s, m_cap=mc, degrees=degrees, **dist)
    out["9a_cgavi-ihb"]["profile_batched"] = profile_device(
        "class-batched cgavi-ihb fit of both classes",
        lambda: api.fit_classes(classes, "oavi:cgavi-ihb", psi=PSI),
        watch=("ihb_update_kernel",))
    out["9a_cgavi-ihb"]["profile_sequential"] = profile_device(
        "sequential cgavi-ihb fit of both classes",
        lambda: api.fit_classes(classes, "oavi:cgavi-ihb", psi=PSI, class_batch="off"),
        watch=("ihb_update_kernel",))

    sizes = synthetic.lognormal_sizes(16, 4096, seed=16)
    log(f"phase 9b: multiclass_planted(lognormal_sizes(16, 4096, seed=16), n=4, seed=116), "
        f"psi=0.005; sizes {sizes}; groups {class_batch.plan_class_groups(sizes)}")
    X9, y9 = synthetic.multiclass_planted(sizes, n=4, seed=116)
    X9 = MinMaxScaler(dtype="float32").fit_transform(X9)
    classes9 = [X9[y9 == c] for c in range(len(sizes))]
    bpcg_ihb = OAVIConfig(psi=PSI, engine="oracle", solver=OracleConfig(name="bpcg"), ihb=True,
                          cap_terms=64)
    for tag, cfg in (("fast", OAVIConfig(psi=PSI, cap_terms=64)), ("bpcg-ihb", bpcg_ihb)):
        bat, bat_log, launches, rec = batched_vs_sequential(f"9b {tag}", classes9, "oavi",
                                                            config=cfg)
        t0 = time.perf_counter()
        cpu, cpu_log = recording_fit(lambda: api.fit_classes(classes9, "oavi", psi=PSI,
                                                             config=cfg, device="cpu"))
        cpu_s = time.perf_counter() - t0
        why, banded = judge_structure(bat, cpu, bat_log, cpu_log)
        if why is not None:
            raise AssertionError(f"9b {tag}: {why}")
        log(f"  9b {tag}: CPU fit {cpu_s:.3f} s; verdicts and structure equal on card and CPU"
            + (" (up to a banded candidate)" if banded else ""))
        out[f"9b_{tag}"] = dict(rec, cpu_s=cpu_s)

    log("phase 9c: class-batched fast fit of both classes of uci_like('spam') (n=57), "
        "psi=0.005")
    X, y = synthetic.uci_like("spam", seed=0)
    Xsp = MinMaxScaler(dtype="float32").fit_transform(X)
    spam = [Xsp[y == c] for c in np.unique(y)]
    bat, bat_log, launches, rec = batched_vs_sequential("9c fast", spam, "oavi:fast")
    if bat[0].stats["Lcap_final"] != 2048 or launches["ihb_degree_batched"] <= 0:
        raise AssertionError(f"9c: Lcap {bat[0].stats['Lcap_final']}, launches {launches}")
    t0 = time.perf_counter()
    cpu, cpu_log = recording_fit(lambda: api.fit_classes(spam, "oavi:fast", psi=PSI,
                                                         device="cpu"))
    cpu_s = time.perf_counter() - t0
    dist = judge_oracle_fits("fast", bat, cpu, bat_log, cpu_log, spam)
    log(f"  9c: borders {[m.stats['border_sizes'] for m in bat]}; CPU fit {cpu_s:.3f} s, held "
        f"by the float64 witness: {dist}")
    out["9c_fast"] = dict(rec, cpu_s=cpu_s, **dist)
    launches_by_path["9c"] = launches
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 products were left on")
    return launches_by_path, out


# ---------------------------------------------------------------------------
# Phase 10: out-of-core and incremental OAVI
# ---------------------------------------------------------------------------

STREAM_CHUNKS = (256, 1024, 4096)
# the reference streaming benchmark's sweep (benchmarks/bench_streaming.py):
# 128x, up to >= 1e7 rows
SCALE_ROWS = (131_072, 2_097_152, 16_777_216)
# streamed peak device bytes across the sweep: the reference benchmark's
# assertion
PEAK_RATIO = 1.5


def planted_stream(m, scaler=None):
    """Generator-backed planted stream of m rows (n = 3, seed 0) under a
    streaming min-max scaler fitted on it in one pass, or the one given."""
    from repro_torch.data import synthetic
    from repro_torch.streaming import ScaledSource, StreamingMinMaxScaler

    raw = synthetic.planted_source(m, n=3, seed=0)
    if scaler is None:
        scaler = StreamingMinMaxScaler(dtype="float32").fit_source(raw, 4096)
    return ScaledSource(raw, scaler)


def timed(fn):
    """(fn's result, seconds on the host clock up to a device sync)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def peak_run(fn):
    """(result, seconds, device bytes allocated above the level before the
    run at its peak, the absolute peak)."""
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out, s = timed(fn)
    peak = torch.cuda.max_memory_allocated()
    return out, s, peak - before, peak


def _streamed(tag, model, launches):
    """Check a streamed fit's launches (one Gram launch a chunk, one
    ``ihb_degree`` a degree on the fast engine) and log its numbers."""
    st = model.stats
    chunks = st["streaming"]["num_chunks"]
    fold_s = sum(st["degree_times"])
    if launches["gram_update_acc"] != chunks:
        raise AssertionError(f"{tag}: {launches['gram_update_acc']} Gram launches for "
                             f"{chunks} chunks")
    return dict(chunks=chunks, degrees=st["degrees"], degree_s=st["degree_times"],
                chunks_per_s=chunks / fold_s, launches=dict(launches))


def stream_bit_contract():
    """10a: streamed fits equal the card's in-memory fit at every chunk size,
    with prefetch on and off."""
    from repro_torch import api, streaming
    from repro_torch.kernels import ops

    m = SCALE_ROWS[0]
    log(f"phase 10a: streamed fits of planted_source({m}, n=3, seed=0) under a "
        f"StreamingMinMaxScaler, chunk_rows {STREAM_CHUNKS}, against the in-memory fit")
    src = planted_stream(m)
    X = src.read(0, m)
    out, launches_by_path = {}, {}
    for v in ("fast", "cgavi-ihb"):
        ref, ref_s = timed(lambda: api.fit(X, f"oavi:{v}", psi=PSI))
        for c in STREAM_CHUNKS:
            ops.reset_launch_counts()
            model, s = timed(lambda: api.fit(src, f"oavi:{v}", psi=PSI, chunk_rows=c))
            launches = ops.launch_counts()
            _bit_equal_models(f"10a {v} chunk_rows={c}", [model], [ref])
            rec = _streamed(f"10a {v} chunk_rows={c}", model, launches)
            log(f"  10a {v} chunk_rows={c}: {s:.3f} s (in memory {ref_s:.3f} s), bit-identical; "
                f"{rec['chunks']} chunks, {rec['chunks_per_s']:.0f} chunks/s in the folds; "
                f"ihb_degree x{launches['ihb_degree']}, ihb_update x{launches['ihb_update']}")
            out[f"{v}_{c}"] = dict(rec, s=s, in_memory_s=ref_s)
            launches_by_path[v] = launches
        cfg = api.oavi_config_for(v, PSI)
        off, off_s = timed(lambda: streaming.fit(src, cfg, chunk_rows=4096, prefetch=False))
        _bit_equal_models(f"10a {v} prefetch off", [off], [model])
        log(f"  10a {v}: prefetch off {off_s:.3f} s, bit-identical to prefetch on")
        out[f"{v}_prefetch_off_s"] = off_s
    if launches_by_path["cgavi-ihb"]["ihb_update"] <= 0:
        raise AssertionError("10a cgavi-ihb: the streamed oracle path launched no ihb_update")
    return out, launches_by_path


def stream_paper_scale():
    """10b: class 0 of the Appendix C set, streamed at chunk_rows=4096: the
    card's in-memory fit's bits, and the CPU's streamed fit's structure and
    float64-witness distance."""
    import importlib

    from repro_torch import api
    from repro_torch.core.transform import MinMaxScaler
    from repro_torch.data import synthetic
    from repro_torch.kernels import ops

    # the module (the package's ``fit`` is the function): its degree loop's
    # collect_degree is the one recording_fit wraps
    streaming_fit = importlib.import_module("repro_torch.streaming.fit")
    log("phase 10b: api.fit(class 0 of appendix_c(m=2_000_000, seed=0), 'oavi', "
        "chunk_rows=4096) on the card")
    X, y = synthetic.appendix_c(m=2_000_000, seed=0)
    X0 = MinMaxScaler(dtype="float32").fit_transform(X)[y == 0]
    ops.reset_launch_counts()
    (card, card_log), s = timed(lambda: recording_fit(
        lambda: api.fit(X0, "oavi", psi=PSI, chunk_rows=4096), streaming_fit))
    launches = ops.launch_counts()
    rec = _streamed("10b", card, launches)
    if launches["ihb_degree"] != len(card.stats["degrees"]):
        raise AssertionError(f"10b: ihb_degree launched {launches['ihb_degree']} times for "
                             f"{len(card.stats['degrees'])} degrees")
    mem, mem_s = timed(lambda: api.fit(X0, "oavi", psi=PSI))
    _bit_equal_models("10b streamed vs in memory", [card], [mem])
    (cpu, cpu_log), cpu_s = timed(lambda: recording_fit(
        lambda: api.fit(X0, "oavi", psi=PSI, chunk_rows=4096, device="cpu"), streaming_fit))
    why, dist = judge_fits([card], [cpu], card_log, cpu_log, [lstsq_coeffs(cpu, X0)],
                           FIT_DIRECT_TOL)
    if why is not None:
        raise AssertionError(f"10b: the card's streamed fit against the CPU's: {why}")
    log(f"  10b: m={X0.shape[0]} streamed {s:.3f} s, in memory {mem_s:.3f} s, bit-identical; "
        f"borders {card.stats['border_sizes']}, {rec['chunks']} chunks, "
        f"{rec['chunks_per_s']:.0f} chunks/s in the folds; launches {launches}; CPU streamed "
        f"{cpu_s:.3f} s, held by the float64 witness: {dist}")
    return dict(rec, m=int(X0.shape[0]), s=s, in_memory_s=mem_s, cpu_s=cpu_s, **dist), launches


def stream_scale():
    """10c: the streamed fast fit across the reference's sweep: seconds,
    chunks and peak device bytes; at the largest m also at 65,536-row chunks
    and in memory, both bit-identical to the 4,096-row streamed fit."""
    from repro_torch import api

    log(f"phase 10c: streamed fast fits of the planted stream at m = {SCALE_ROWS}, "
        f"chunk_rows=4096")
    out, peaks = {}, []
    for m in SCALE_ROWS:
        src, scale_s = timed(lambda: planted_stream(m))
        model, s, peak, peak_abs = peak_run(
            lambda: api.fit(src, "oavi", psi=PSI, chunk_rows=4096))
        rec = _streamed(f"10c m={m}", model, model.stats["kernel_launches"])
        peaks.append(peak)
        log(f"  10c m={m}: {s:.3f} s (scaler pass {scale_s:.3f} s); borders "
            f"{model.stats['border_sizes']}; {rec['chunks']} chunks, {rec['chunks_per_s']:.0f} "
            f"chunks/s in the folds, degree seconds {[round(t, 3) for t in rec['degree_s']]}; "
            f"peak device bytes {peak} above the start ({peak_abs} absolute)")
        out[m] = dict(rec, s=s, scaler_s=scale_s, peak_bytes=peak, peak_bytes_abs=peak_abs)
    if max(peaks) > PEAK_RATIO * min(peaks):
        raise AssertionError(f"10c: streamed peak device bytes {peaks} vary more than "
                             f"{PEAK_RATIO}x across the sweep")
    log(f"  10c: streamed peaks within {max(peaks) / min(peaks):.3f}x across a "
        f"{SCALE_ROWS[-1] // SCALE_ROWS[0]}x sweep of m")
    m = SCALE_ROWS[-1]
    wide, s, peak, _ = peak_run(lambda: api.fit(src, "oavi", psi=PSI, chunk_rows=65536))
    _bit_equal_models("10c chunk_rows=65536", [wide], [model])
    rec = _streamed(f"10c m={m} chunk_rows=65536", wide, wide.stats["kernel_launches"])
    log(f"  10c m={m} chunk_rows=65536: {s:.3f} s, bit-identical; {rec['chunks']} chunks, "
        f"{rec['chunks_per_s']:.0f} chunks/s in the folds; peak device bytes {peak}")
    out["chunk_65536"] = dict(rec, s=s, peak_bytes=peak)
    X, read_s = timed(lambda: src.read(0, m))
    mem, s, peak, _ = peak_run(lambda: api.fit(X, "oavi", psi=PSI))
    del X
    _bit_equal_models("10c in memory", [mem], [model])
    log(f"  10c m={m} in memory: {s:.3f} s (host read {read_s:.3f} s), bit-identical; peak "
        f"device bytes {peak} against {out[m]['peak_bytes']} streamed")
    out["in_memory"] = dict(s=s, read_s=read_s, peak_bytes=peak)
    src2 = planted_stream(SCALE_ROWS[1])
    out["profile"] = profile_device(
        f"streamed fast fit, m={SCALE_ROWS[1]}, chunk_rows=4096",
        lambda: api.fit(src2, "oavi", psi=PSI, chunk_rows=4096), watch=("gram",))
    return out, src, model


def stream_online(src, refit):
    """10d: online.fit on the first 15/16 of the largest stream, api.update
    with the rest: the streamed refit's bits; then again from a saved and
    loaded FitState."""
    import shutil

    from repro_torch import api, online
    from repro_torch.kernels import ops

    m = src.num_rows
    base = m - m // 16
    log(f"phase 10d: online fit of {base} rows, api.update to {m} rows (chunk_rows=4096)")
    prefix = planted_stream(base, scaler=src.scaler)
    model0, fit_s = timed(lambda: api.fit(prefix, "oavi", psi=PSI, chunk_rows=4096,
                                          capture_state=True))
    ops.reset_launch_counts()
    res, up_s = timed(lambda: api.update(model0, model0.fit_state, src))
    launches = ops.launch_counts()
    _bit_equal_models("10d update vs refit", [res.model], [refit])
    st = res.stats
    if st["replayed_degrees"] or st["folded_degrees"] != len(model0.fit_state.records):
        raise AssertionError(f"10d: expected every degree to fold: {st}")
    if launches["gram_update_acc"] != st["chunks"]:
        raise AssertionError(f"10d: {launches['gram_update_acc']} Gram launches for "
                             f"{st['chunks']} chunks")
    ckpt = os.path.join(HERE, "build", "chip_smoke_fit_state")
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        (_, save_s) = timed(lambda: model0.fit_state.save(ckpt))
        loaded, load_s = timed(lambda: online.FitState.load(ckpt))
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    again, again_s = timed(lambda: api.update(model0, loaded, src))
    _bit_equal_models("10d update from a loaded FitState", [again.model], [refit])
    refit_chunks = refit.stats["streaming"]["num_chunks"]
    log(f"  10d: online fit {fit_s:.3f} s; update {up_s:.3f} s folding {st['chunks']} chunks "
        f"({st['folded_degrees']} degrees folded, none replayed) against the refit's "
        f"{refit.stats['time_total']:.3f} s and {refit_chunks} chunks; bit-identical to the "
        f"refit; FitState save {save_s:.3f} s, load {load_s:.3f} s, update from it "
        f"{again_s:.3f} s, bit-identical")
    return dict(base_rows=base, fit_s=fit_s, update_s=up_s, update_chunks=st["chunks"],
                refit_s=refit.stats["time_total"], refit_chunks=refit_chunks, save_s=save_s,
                load_s=load_s, update_from_loaded_s=again_s, launches=launches)


def stream_class_batch():
    """10e: the 16 skewed classes of phase 9b, class-batched streaming,
    against each class's own streamed fit."""
    from repro_torch import api
    from repro_torch.core.oavi import OAVIConfig
    from repro_torch.core.oracles import OracleConfig
    from repro_torch.core.transform import MinMaxScaler
    from repro_torch.data import synthetic
    from repro_torch.kernels import ops

    sizes = synthetic.lognormal_sizes(16, 4096, seed=16)
    log("phase 10e: api.fit_classes(..., chunk_rows=4096) of the phase-9b classes")
    X9, y9 = synthetic.multiclass_planted(sizes, n=4, seed=116)
    X9 = MinMaxScaler(dtype="float32").fit_transform(X9)
    classes = [X9[y9 == c] for c in range(len(sizes))]
    bpcg_ihb = OAVIConfig(psi=PSI, engine="oracle", solver=OracleConfig(name="bpcg"), ihb=True,
                          cap_terms=64)
    out = {}
    for tag, cfg in (("fast", OAVIConfig(psi=PSI, cap_terms=64)), ("bpcg-ihb", bpcg_ihb)):
        ops.reset_launch_counts()
        bat, bat_s = timed(lambda: api.fit_classes(classes, "oavi", config=cfg, chunk_rows=4096))
        launches = ops.launch_counts()
        seq, seq_s = timed(lambda: [api.fit(X, "oavi", config=cfg, chunk_rows=4096)
                                    for X in classes])
        _bit_equal_models(f"10e {tag}", bat, seq)
        degrees = max(len(m.stats["degrees"]) for m in bat)
        chunks = sum(m.stats["streaming"]["num_chunks"] for m in bat)
        step = launches["ihb_degree_batched"] if tag == "fast" else launches["ihb_update_batched"]
        if launches["gram_update_acc"] != chunks or launches["gram_update_acc_batched"]:
            raise AssertionError(f"10e {tag}: Gram launches {launches} for {chunks} chunks")
        if tag == "fast" and step != degrees:
            raise AssertionError(f"10e fast: {step} ihb_degree_batched launches for "
                                 f"{degrees} degrees")
        agg = api.aggregate_fit_stats(bat)
        log(f"  10e {tag}: batched {bat_s:.3f} s, per-class streamed {seq_s:.3f} s, "
            f"bit-identical; {degrees} degrees, statistics-step launches "
            f"{'ihb_degree_batched' if tag == 'fast' else 'ihb_update_batched'} x{step} "
            f"({step / degrees:.1f} a degree); escalations {agg['solver_escalations']}; "
            f"{chunks} chunks")
        out[tag] = dict(batched_s=bat_s, per_class_s=seq_s, degrees=degrees, step_launches=step,
                        escalations=agg["solver_escalations"], chunks=chunks, launches=launches)
    return out


def main_path_streaming(dev):
    """Phase 10: the streaming path's kernels at its shapes, then 10a-10e."""
    log("phase 10: out-of-core and incremental OAVI on the card")
    # the streamed fit's Gram at its chunk shapes, with a carry; its degree
    # loop at paper scale's degree 2 (Lcap = Kcap = 64, ell0 = 4, K = 6)
    kernels = dict(gram_chunk=check_gram_acc(dev, 4096, 64, 3, 64, split_blocks=7, reps=50),
                   gram_chunk_65536=check_gram_acc(dev, 65536, 64, 3, 64, split_blocks=97,
                                                   reps=20),
                   degree=check_ihb_degree(dev, 64, 4, 6, 64, reps=20))
    contract, bit_launches = stream_bit_contract()
    paper, paper_launches = stream_paper_scale()
    scale, src, refit = stream_scale()
    online_rec = stream_online(src, refit)
    batched = stream_class_batch()
    return kernels, dict(paper=paper_launches, **bit_launches), dict(
        bit_contract=contract, paper=paper, scale=scale, online=online_rec,
        class_batched=batched)


# ---------------------------------------------------------------------------
# Phase 11: serving (the (FT) stack) and the fits' observability
# ---------------------------------------------------------------------------

SERVE_REQUESTS = 2048
SERVE_ARGS = ["--requests", str(SERVE_REQUESTS), "--mean-rows", "128", "--concurrency", "8",
              "--max-delay-ms", "2", "--max-batch-rows", "8192"]


@contextlib.contextmanager
def obs_profile(path):
    """``OBS_TORCH_PROFILE=path`` for the duration (the obs profiler
    windows capture there)."""
    old = os.environ.get("OBS_TORCH_PROFILE")
    os.environ["OBS_TORCH_PROFILE"] = path
    try:
        yield
    finally:
        if old is None:
            del os.environ["OBS_TORCH_PROFILE"]
        else:
            os.environ["OBS_TORCH_PROFILE"] = old


def serve_summary(tag, report, terms):
    """Log one replay's report; returns its numbers, with the launches per
    device call (hand kernels from the counts, ``addcmul`` from the
    profile when there is one)."""
    out = {k: report[k] for k in ("requests", "rows", "wall_s", "rows_per_s", "requests_per_s",
                                  "lat_p50_ms", "lat_p90_ms", "lat_p99_ms", "lat_p999_ms",
                                  "lat_max_ms", "device_calls", "padded_rows", "batches",
                                  "requests_per_batch", "recompiles")}
    msg = (f"  {tag}: {report['requests']} requests ({report['rows']} rows) in "
           f"{report['wall_s']:.3f} s, {report['rows_per_s']:.0f} rows/s, "
           f"{report['requests_per_s']:.1f} req/s; latency ms p50 {report['lat_p50_ms']:.3f} "
           f"p90 {report['lat_p90_ms']:.3f} p99 {report['lat_p99_ms']:.3f} "
           f"p999 {report['lat_p999_ms']:.3f}; {report['device_calls']} device calls, "
           f"{report['padded_rows']} padded rows, {report['requests_per_batch']:.2f} requests "
           f"a coalesced call, {report['recompiles']} recompiles")
    if "device_busy_s" in report:
        addcmul = sum(n for k, n in report["kernel_launches_by_name"].items() if "addcmul" in k)
        launches = sum(report["kernel_launches_by_name"].values())
        out.update(device_busy_s=report["device_busy_s"],
                   device_idle_share=report["device_idle_share"],
                   addcmul_per_call=addcmul / report["device_calls"],
                   launches_per_call=launches / report["device_calls"])
        # the engine's worker thread launches: the profiler sees its kernels
        # (device activity) but not its host ops, so these are counts of
        # kernels by name; a call of a book of L terms makes L - 1 addcmul
        msg += (f"; profiled: device busy {report['device_busy_s'] * 1e3:.3f} ms, idle share "
                f"{100 * report['device_idle_share']:.1f}%, {out['launches_per_call']:.1f} "
                f"kernels a call of which addcmul {out['addcmul_per_call']:.1f} "
                f"(the fused book has {terms} terms: {terms - 1} expected)")
    log(msg)
    if report["recompiles"] != 0:
        raise AssertionError(f"{tag}: {report['recompiles']} recompiles after warm-up")
    return out


def serve_paper_scale(clf, Xte, tmp):
    """11a-c: the phase-3 classifier saved, loaded through the registry and
    served by ``serve_vi`` (predict, then transform under a profile), the
    test split through the engine, a hot swap and a chaos replay."""
    import torch

    from repro_torch import api
    from repro_torch.kernels import ops
    from repro_torch.launch import serve_vi
    from repro_torch.resilience import chaos
    from repro_torch.serving import BatcherConfig, MicroBatcher, ModelRegistry

    log("phase 11a: serve_vi over the phase-3 classifier (saved, then ModelRegistry.load on "
        f"the card), {SERVE_REQUESTS} requests of synth_trace(mean_rows=128, seed=0), "
        "concurrency 8, max_delay_ms 2, max_batch_rows 8192")
    path = os.path.join(tmp, "clf")
    clf.save(path)
    payloads = serve_vi.make_payloads(clf.scaler.transform,
                                      serve_vi.synth_trace(SERVE_REQUESTS, 128, 0), 0)
    direct = [api.feature_transform(clf.models, p) for p in payloads]
    launches0 = ops.launch_counts()
    labels = []
    rep = serve_vi.main(["--model-dir", path, "--kind", "predict"] + SERVE_ARGS, replies=labels)
    feats = []
    with obs_profile(os.path.join(tmp, "profile")):
        rep_t = serve_vi.main(["--model-dir", path, "--kind", "transform"] + SERVE_ARGS,
                              replies=feats)
    if ops.launch_counts() != launches0:
        raise AssertionError("serving launched a hand-written kernel")
    for i, (lab, f, d) in enumerate(zip(labels, feats, direct)):
        if not np.array_equal(f, d):
            raise AssertionError(f"11a: transform reply {i} differs from the direct transform")
        if not np.array_equal(lab, clf.head(d)):
            raise AssertionError(f"11a: predicted labels of request {i} differ from clf's")
    terms = len(api._fuse(clf.models).parents)
    out = dict(predict=serve_summary("predict", rep, terms),
               transform=serve_summary("transform, profiled", rep_t, terms),
               hand_kernel_launches_per_call=0, terms=terms)

    log("phase 11b: the 800,000-row test split through engine.transform (16,384-row chunks)")
    want = clf.transform(Xte)  # the direct path: no engine attached yet
    eng = clf.attach_engine()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = clf.transform(Xte)
    split_s = time.perf_counter() - t0
    calls = eng.stats["device_calls"]
    if not np.array_equal(got, want):
        raise AssertionError("11b: engine transform of the test split differs from direct")
    if calls != -(-Xte.shape[0] // eng.max_bucket):
        raise AssertionError(f"11b: {calls} device calls")
    log(f"  {Xte.shape[0]} rows in {split_s:.3f} s ({Xte.shape[0] / split_s:.0f} rows/s), "
        f"{calls} device calls, {eng.stats['padded_rows']} padded rows; bit-equal to direct")
    out["test_split"] = dict(rows=int(Xte.shape[0]), seconds=split_s, device_calls=calls)
    clf.engine = None

    log("phase 11c: hot swap (chaos site registry.activate) and a chaos replay "
        "(one transient fault, one poison request at engine.transform)")
    from repro_torch.core.pipeline import PipelineConfig, VanishingIdealClassifier
    from repro_torch.data import synthetic

    reg = ModelRegistry()
    v1 = reg.load("clf", path)
    Xs, ys = synthetic.appendix_c(m=100_000, seed=1)
    other = VanishingIdealClassifier(PipelineConfig(method="fast", psi=0.01)).fit(Xs, ys)
    v2 = reg.register("clf", other, activate=False)
    chaos.install(chaos.FaultPlan([chaos.Fault(site="registry.activate", at=1,
                                               action="raise")]))
    try:
        reg.activate("clf", v2.version)
        raise AssertionError("11c: the injected activation fault did not fire")
    except chaos.InjectedFault:
        pass
    finally:
        chaos.uninstall()
    if reg.active_version("clf") != v1.version:
        raise AssertionError("11c: a failed activation moved the active version")
    req = Xte[:1000]
    one = reg.get("clf").predict(req)
    reg.activate("clf", v2.version)
    two = reg.get("clf").predict(req)
    if not (np.array_equal(one, clf.predict(req)) and np.array_equal(two, other.predict(req))
            and np.array_equal(reg.get("clf", v1.version).transform(req), want[:1000])
            and np.array_equal(reg.get("clf").transform(req), other.transform(req))):
        raise AssertionError("11c: a version's reply differs from its own direct path")
    sub = payloads[:256]
    poison_at = 100
    bad = sub[poison_at].copy()
    bad[0, 0] = chaos.POISON_SENTINEL
    sub = sub[:poison_at] + [bad] + sub[poison_at + 1:]
    chaos.install(chaos.FaultPlan([
        chaos.Fault(site="engine.transform", at=3, action="raise_transient"),
        chaos.Fault(site="engine.transform", action="poison")]))
    bat = MicroBatcher(v1.engine, config=BatcherConfig(max_delay_ms=2.0, backoff_ms=1.0))
    try:
        with bat:
            futs = [bat.submit(p, "transform") for p in sub]
            results = []
            for f in futs:
                try:
                    results.append(f.result(timeout=120))
                except chaos.PoisonRequestError as e:
                    results.append(e)
    finally:
        plan = chaos.installed()
        chaos.uninstall()
    failed = [i for i, r in enumerate(results) if isinstance(r, Exception)]
    if failed != [poison_at]:
        raise AssertionError(f"11c: requests {failed} failed, expected only {poison_at}")
    for i, r in enumerate(results):
        if i != poison_at and not np.array_equal(r, direct[i]):
            raise AssertionError(f"11c: rider {i} differs from the fault-free reply")
    st = bat.stats
    if st["retries"] < 1 or st["isolated_failures"] != 1:
        raise AssertionError(f"11c: retries {st['retries']}, isolated {st['isolated_failures']}")
    log(f"  swap: v{v1.version} -> v{v2.version} after one injected activation failure; "
        f"each version's replies equal its own direct path.  chaos replay of {len(sub)} "
        f"requests: {st['retries']} retry, {st['bisections']} bisections, "
        f"{st['isolated_failures']} isolated failure (request {poison_at}), every other "
        f"reply bit-equal to the fault-free one; fired {plan.fired[:4]}")
    out["chaos"] = dict(retries=st["retries"], bisections=st["bisections"],
                        isolated_failures=st["isolated_failures"], batches=st["batches"])
    return out


def serve_wide(wide_fast, tmp):
    """11d: an engine over phase 4's wide model (Lcap = 2048): the
    launch-bound case, one addcmul launch a term of the book per call."""
    from repro_torch import api, obs
    from repro_torch.launch import serve_vi
    from repro_torch.serving import MicroBatcher, TransformEngine

    X0, model, _ = wide_fast
    eng = TransformEngine([model])
    eng.warmup()
    sizes = serve_vi.synth_trace(256, 128, 0)
    rng = np.random.default_rng(1)
    payloads = [X0[o:o + q] for q, o in
                ((q, int(rng.integers(0, X0.shape[0] - q + 1))) for q in sizes)]
    log(f"phase 11d: full width, {eng!r}, 256 requests of synth_trace(mean_rows=128)")
    replies = []
    with obs_profile(os.path.join(tmp, "profile_wide")):
        with obs.device.profile_window("wide/replay") as win:
            with MicroBatcher(eng) as bat:
                rep = serve_vi.replay(bat, payloads, kind="transform", concurrency=8,
                                      replies=replies)
    busy_s, by_kernel = obs.device.profile_kernels(win.prof)
    for i, (p, r) in enumerate(zip(payloads, replies)):
        if not np.array_equal(r, api.feature_transform([model], p)):
            raise AssertionError(f"11d: reply {i} differs from the direct transform")
    es, bs = eng.stats, bat.stats
    rep.update(device_calls=es["device_calls"], padded_rows=es["padded_rows"],
               batches=bs["batches"], requests_per_batch=bs["requests"] / bs["batches"],
               recompiles=es["recompiles"], device_busy_s=busy_s,
               device_idle_share=1 - busy_s / rep["wall_s"], kernel_launches_by_name=by_kernel)
    return serve_summary("wide", rep, eng.terms)


def fit_observed(paper_data, tmp):
    """11e: the phase-3 generator fit (class-batched, fast) again with obs
    on, every span a record_function range, in a profile window; against
    the same fit with obs off."""
    import torch

    from repro_torch import api, obs
    from repro_torch.core import oavi
    from repro_torch.kernels import ops
    from repro_torch.launch import obs_report

    from repro_torch.core.transform import MinMaxScaler

    Xtr, ytr = paper_data[0], paper_data[1]
    Xs = MinMaxScaler(dtype="float32").fit_transform(Xtr)
    classes = [Xs[ytr == c] for c in np.unique(ytr)]
    log("phase 11e: the phase-3 generator fit with obs on (spans, record_function, a "
        "torch.profiler window) against obs off")
    with obs.disabled():
        off_s = []
        for _ in range(2):
            t0 = time.perf_counter()
            off = api.fit_classes(classes, psi=PSI)
            torch.cuda.synchronize()
            off_s.append(time.perf_counter() - t0)
    on_s = []
    for _ in range(2):
        t0 = time.perf_counter()
        api.fit_classes(classes, psi=PSI)
        torch.cuda.synchronize()
        on_s.append(time.perf_counter() - t0)
    obs.reset()
    obs.configure(torch_trace=True)
    degrees = []
    gram, collect = ops.gram_accumulate_batched, oavi.collect_degree

    def rec_gram(A, X, parents, vars_, acc=None, **kw):
        degrees.append((A.shape[0], A.shape[1], A.shape[2], X.shape[2], parents.shape[-1], []))
        return gram(A, X, parents, vars_, acc, **kw)

    def rec_collect(book, border, accepted, mses, coeffs, generators):
        degrees[-1][5].append((len(book), np.asarray(accepted[: len(border)], bool)))
        return collect(book, border, accepted, mses, coeffs, generators)

    ops.gram_accumulate_batched, oavi.collect_degree = rec_gram, rec_collect
    try:
        with obs_profile(os.path.join(tmp, "profile_fit")):
            on = api.fit_classes(classes, psi=PSI)
            torch.cuda.synchronize()
    finally:
        ops.gram_accumulate_batched, oavi.collect_degree = gram, collect
        obs.configure(torch_trace=False)
    for a, b in zip(on, off):
        if a.book.terms != b.book.terms or not all(
                np.array_equal(x.coeffs, y.coeffs) for x, y in zip(a.generators, b.generators)):
            raise AssertionError("11e: the obs-on fit's generators differ from obs-off")
    st = on[0].stats
    parts = st["time_setup"] + st["time_degrees"] + st["time_finalize"] + st["time_unattributed"]
    if abs(st["time_total"] - parts) > 1e-9:
        raise AssertionError(f"11e: timing contract off by {st['time_total'] - parts}")
    # held against this script's own counts (gram_work, degree_work) at the
    # shapes the fit dispatched: the Gram at its block-padded rows and
    # capacity columns, the candidate loop on each class's real decisions
    def dispatched(k, m, L, n, K, decided):
        m_pad = -(-m // ops.GRAM_BLOCK) * ops.GRAM_BLOCK
        gram = gram_work(torch.empty((m_pad, L), device="meta"),
                         torch.empty((m_pad, n), device="meta"),
                         torch.empty((K,), dtype=torch.int32, device="meta"), carry=False)[0]
        return k * gram + sum(degree_work(acc, ell0, len(acc), L)[0] if len(acc) else 0.0
                              for ell0, acc in decided)

    want = [dispatched(*d) for d in degrees]
    if st["flops_per_degree"] != want:
        raise AssertionError(f"11e: flops_per_degree {st['flops_per_degree']} != {want}")
    obs_dir = os.path.join(tmp, "obs")
    os.makedirs(obs_dir, exist_ok=True)
    obs.export_metrics(os.path.join(obs_dir, "metrics.jsonl"))
    obs.export_trace(os.path.join(obs_dir, "trace.json"))
    with open(os.path.join(obs_dir, "trace.json")) as f:
        events = obs.validate_chrome_trace(json.load(f))
    profiles = sorted(os.listdir(os.path.join(tmp, "profile_fit")))
    if not profiles:
        raise AssertionError("11e: the profile window wrote no trace")
    summary = obs_report.trace_summary(os.path.join(obs_dir, "trace.json"))
    top = sorted(summary["spans"].items(), key=lambda kv: -kv[1]["total_s"])[:6]
    lines = obs_report.report(obs_dir)
    log(f"  obs off {off_s} s, obs on {on_s} s (median overhead "
        f"{float(np.median(on_s)) - float(np.median(off_s)):+.4f} s); timing contract "
        f"{st['time_total']:.6f} = setup {st['time_setup']:.6f} + degrees "
        f"{st['time_degrees']:.6f} + finalize {st['time_finalize']:.6f} + unattributed "
        f"{st['time_unattributed']:.6f} s; flops_per_degree {st['flops_per_degree']} "
        f"(analytic), achieved {st['achieved_gflops']} GFLOP/s, compile_seconds "
        f"{st['compile_seconds']}; {len(events)} trace events, profile {profiles[0]}; "
        f"obs_report: {len(lines)} lines")
    for name, sp in top:
        log(f"    span {name:<24} n={sp['n']:<4} total {sp['total_s'] * 1e3:.3f} ms "
            f"mean {sp['mean_ms']:.3f} ms")
    return dict(off_s=off_s, on_s=on_s, time_total=st["time_total"],
                time_setup=st["time_setup"], time_degrees=st["time_degrees"],
                time_finalize=st["time_finalize"], time_unattributed=st["time_unattributed"],
                flops_per_degree=st["flops_per_degree"], achieved_gflops=st["achieved_gflops"],
                top_spans={k: v for k, v in top})


def main_path_serving(clf, paper_data, wide_fast):
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        out = serve_paper_scale(clf, paper_data[2], tmp)
        out["wide"] = serve_wide(wide_fast, tmp)
        out["fit_obs"] = fit_observed(paper_data, tmp)
        out["seconds"] = time.perf_counter() - t0
    log(f"  phase 11: {out['seconds']:.1f} s")
    return out


def profile_device(tag, fn, watch=()):
    """Device time by kernel over one call of ``fn`` (after a warm-up call),
    and the device's busy share of its wall time, from ``torch.profiler``.
    Kernels whose name contains a string of ``watch`` are logged and
    returned whether or not they are among the top rows."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernels only: an operator's device time repeats its kernels'
    rows = sorted(((ev.self_device_time_total / 1e3, ev.count, ev.key)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0),
                  reverse=True)
    busy_ms = sum(r[0] for r in rows)
    log(f"  profiled {tag}: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%), idle share {100 * (1 - busy_ms / wall_ms):.1f}%, "
        f"{sum(r[1] for r in rows)} kernel launches")
    shown = rows[:8] + [r for r in rows[8:] if any(w in r[2] for w in watch)]
    for ms, count, key in shown:
        log(f"    {ms:9.3f} ms {100 * ms / max(busy_ms, 1e-9):5.1f}% x{count:<5d} {key[:90]}")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, launches=sum(r[1] for r in rows),
                top=[dict(ms=ms, count=count, name=key[:120]) for ms, count, key in shown])


# ---------------------------------------------------------------------------
# Phase 12: the continuous controller (journal, continuous_vi, chaos_vi)
# ---------------------------------------------------------------------------

# a feature store that appends 131,072-row batches (1/16 of the base each) to
# a 2,097,152-row fit while the classifier serves; the third batch drifts
LOOP_BASE, LOOP_INCREMENTS, LOOP_INCREMENT = 2_097_152, 4, 131_072
LOOP_ARGS = ["--base-rows", str(LOOP_BASE), "--increments", str(LOOP_INCREMENTS),
             "--increment-rows", str(LOOP_INCREMENT), "--shard-rows", str(LOOP_INCREMENT),
             "--chunk-rows", "65536", "--min-update-rows", str(LOOP_INCREMENT),
             "--drift-at-increment", "2", "--serve-threads", "2"]
UPDATE_KINDS = ("update_start", "state_saved", "staged", "activated")


class RowPrefix:
    """The first ``rows`` rows of a data source."""

    def __init__(self, source, rows):
        self.source, self.num_rows, self.num_features = source, rows, source.num_features

    def read(self, start, stop):
        return self.source.read(start, min(stop, self.num_rows))


def check_journal_order(path):
    """12c: the run's journal, replayed: base_fitted first, done last, the
    ingests in order, and each update's four transitions in order."""
    from repro_torch.resilience import Journal

    with Journal(path) as j:
        records = j.replay()
    kinds = [r["kind"] for r in records]
    if kinds[0] != "base_fitted" or kinds[-1] != "done":
        raise AssertionError(f"12c: journal runs {kinds[0]} .. {kinds[-1]}")
    ingested = [r["batch"] for r in records if r["kind"] == "ingested"]
    if ingested != list(range(LOOP_INCREMENTS)):
        raise AssertionError(f"12c: ingested batches {ingested}")
    by_update = {}
    for r in records:
        if r["kind"] in UPDATE_KINDS:
            by_update.setdefault(r["update"], []).append(r["kind"])
    if not by_update or any(ks != list(UPDATE_KINDS) for ks in by_update.values()):
        raise AssertionError(f"12c: update transitions out of order: {by_update}")
    return kinds


def loop_on_card(tmp):
    """12a: ``continuous_vi.main`` on the card, held against the card's and
    the CPU's streamed refits of every row; one update profiled."""
    import importlib

    import torch

    from repro_torch import api, online, streaming
    from repro_torch.core.oavi import OAVIConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import continuous_vi
    from repro_torch.streaming import ScaledSource, ShardDirSource
    from repro_torch.streaming.scaler import StreamingMinMaxScaler

    streaming_fit = importlib.import_module("repro_torch.streaming.fit")
    workdir = os.path.join(tmp, "loop")
    log(f"phase 12a: continuous_vi.main({' '.join(LOOP_ARGS)}) on the card")
    ops.reset_launch_counts()
    report, s = timed(lambda: continuous_vi.main(
        LOOP_ARGS + ["--workdir", workdir, "--obs-dir", os.path.join(tmp, "loop_obs")]))
    launches = ops.launch_counts()
    ups, serve = report["updates"], report["serve"]
    if serve["mismatches"] or not serve["requests"]:
        raise AssertionError(f"12a: {serve['mismatches']} mismatches in {serve['requests']} "
                             "requests")
    if len(report["staleness_s"]) != LOOP_INCREMENTS or report["update_failures"]:
        raise AssertionError(f"12a: {len(report['staleness_s'])} of {LOOP_INCREMENTS} "
                             f"arrivals activated, failures {report['update_failures']}")
    if report["warm_recompiles"] or not any(u["drift"]["triggered"] for u in ups):
        raise AssertionError(f"12a: warm kernel builds {report['warm_recompiles']}, drift "
                             f"{[u['drift']['triggered'] for u in ups]}")
    for u in ups:
        kl = u["kernel_launches"]
        degrees = u["folded_degrees"] + len(u["replayed_degrees"])
        if kl["gram_update_acc"] != u["chunks"] or kl["ihb_degree"] != degrees:
            raise AssertionError(f"12a: update v{u['version']} launched {kl} for "
                                 f"{u['chunks']} chunks, {degrees} degrees")
    scaler = StreamingMinMaxScaler().fit(
        continuous_vi.arrival_batch(-1, LOOP_BASE, 3, 0))
    src = ScaledSource(ShardDirSource(os.path.join(workdir, "shards")), scaler)
    final = api.load(report["final_model"])
    cfg = OAVIConfig(psi=PSI, engine="fast")
    (refit, card_log), refit_s = timed(lambda: recording_fit(
        lambda: streaming.fit(src, cfg, chunk_rows=65536), streaming_fit))
    _bit_equal_models("12a final model vs the streamed refit", [final], [refit])
    (cpu, cpu_log), cpu_s = timed(lambda: recording_fit(
        lambda: streaming.fit(src, cfg, chunk_rows=65536, device="cpu"), streaming_fit))
    X = src.read(0, src.num_rows)
    why, dist = judge_fits([refit], [cpu], card_log, cpu_log, [lstsq_coeffs(cpu, X)],
                           FIT_DIRECT_TOL)
    if why is not None:
        raise AssertionError(f"12a: the card's refit against the CPU's: {why}")
    kinds = check_journal_order(os.path.join(workdir, "journal.jsonl"))
    # the device's view of one update: the last increment folded onto the
    # state of the rows before it
    before = RowPrefix(src.source, src.num_rows - LOOP_INCREMENT)
    model0, state0 = online.fit(ScaledSource(before, scaler), cfg, chunk_rows=65536,
                                scaler=scaler)
    profile = profile_device("one continuous update (the last 131,072 rows)",
                             lambda: api.update(model0, state0, src, scaler=scaler))
    torch.cuda.synchronize()
    per_update = [dict(version=u["version"], new_rows=u["new_rows"], s=u["time_update"],
                       to_active_s=u["time_to_active"], folded=u["folded_degrees"],
                       replayed=u["replayed_degrees"], chunks=u["chunks"],
                       drift=u["drift"]["triggered"]) for u in ups]
    log(f"  12a: {s:.3f} s in all, base fit {report['time_base_fit']:.3f} s; updates "
        f"{per_update}; staleness mean {report['staleness_mean_s']:.3f} s max "
        f"{report['staleness_max_s']:.3f} s; serve p50 {serve['lat_p50_ms']:.3f} ms p99 "
        f"{serve['lat_p99_ms']:.3f} ms, {serve['requests']} requests, "
        f"{serve['during_update_requests']} during updates, 0 mismatches; final model "
        f"bit-identical to the streamed refit ({refit_s:.3f} s), CPU refit {cpu_s:.3f} s held "
        f"by the float64 witness: {dist}; launches {launches}; journal {len(kinds)} records")
    out = dict(s=s, base_fit_s=report["time_base_fit"], updates=per_update,
               staleness_mean_s=report["staleness_mean_s"],
               staleness_max_s=report["staleness_max_s"], lat_p50_ms=serve["lat_p50_ms"],
               lat_p99_ms=serve["lat_p99_ms"], requests=serve["requests"],
               during_update_requests=serve["during_update_requests"], refit_s=refit_s,
               cpu_refit_s=cpu_s, witness=dist, journal_records=len(kinds),
               update_profile=profile, launches=launches)
    return out, launches


def main_path_continuous():
    """Phase 12: the continuous loop, the chaos harness and the journal on
    the card."""
    import tempfile

    from repro_torch.launch import chaos_vi

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        out, launches = loop_on_card(tmp)
        log("phase 12b: chaos_vi.main(['--fast', '--device', 'cuda']): six scenarios, "
            "controllers in subprocesses on the card")
        report, chaos_s = timed(lambda: chaos_vi.main([
            "--fast", "--device", "cuda", "--tmp", os.path.join(tmp, "chaos"),
            "--trace-dir", os.path.join(tmp, "chaos_traces")]))
        if not report["ok"] or len(report["scenarios"]) != 6:
            raise AssertionError(f"12b: {report}")
        kills = report["scenarios"]["kill_resume"]["kills"]
        log(f"  12b: 6 scenarios passed in {chaos_s:.1f} s; kills "
            f"{[(k['phase'], k['caught_up_rows'], round(k['recovery_s'], 3)) for k in kills]} "
            f"resumed bit-identical to the card's uninterrupted run; corrupt state fell back to "
            f"m={report['scenarios']['corrupt_state']['fallback_from_rows']}")
        out["chaos"] = dict(s=chaos_s, kills=[{k: v for k, v in kill.items() if k != "trace"}
                                              for kill in kills])
        out["seconds"] = time.perf_counter() - t0
    log(f"  phase 12: {out['seconds']:.1f} s")
    return out, launches


# ---------------------------------------------------------------------------
# Phase 13: data-parallel OAVI over torch.distributed
# ---------------------------------------------------------------------------

RANK_PROGRAM = """
import json, os, sys, time
import numpy as np
import torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

rank, world, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", store=dist.FileStore(os.path.join(work, "store"), world),
                        rank=rank, world_size=world)
try:
    from repro_torch import api
    from repro_torch.kernels import ops
    torch.cuda.set_device(0)  # every rank on the one card
    mesh = init_device_mesh("cuda", (world,), mesh_dim_names=("data",))
    X = np.load(os.path.join(work, "X0.npy"))
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = api.fit(X, "oavi", psi=%r, backend="sharded", mesh=mesh)
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    st = model.stats
    np.savez(os.path.join(work, f"rank{rank}.npz"),
             **{f"g{i}": g.coeffs for i, g in enumerate(model.generators)})
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(dict(s=s, terms=[list(t) for t in model.book.terms],
                       gens=[list(g.term) for g in model.generators],
                       degrees=st["degrees"], all_reduces=st["all_reduces"],
                       all_reduce_s=st["all_reduce_seconds"], m_padded=st["m_padded"],
                       launches=ops.launch_counts(), device=torch.cuda.get_device_name()), f)
finally:
    dist.destroy_process_group()
""" % PSI


def _sharded_gates(tag, models, local, launches, per_degree):
    """The world-of-one fits: the local card fit's bits, one all_reduce a
    degree, the local fit's Gram launches a degree."""
    _bit_equal_models(tag, models, local)
    degrees = max(len(m.stats["degrees"]) for m in models)
    if any(m.stats["all_reduces"] != degrees for m in models):
        raise AssertionError(f"{tag}: all_reduces {[m.stats['all_reduces'] for m in models]} "
                             f"for {degrees} degrees")
    for name, want in per_degree.items():
        if launches[name] != want:
            raise AssertionError(f"{tag}: {name} launched {launches[name]} times, "
                                 f"expected {want}")
    return degrees


def world_of_one(classes, clf_models, tmp):
    """13a: a world of one over NCCL: phase 3's classes, class 0 alone and the
    planted stream, each bit for bit the local card fit."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import api
    from repro_torch.kernels import ops

    log("phase 13a: a world of one over NCCL (init_device_mesh('cuda', (1,)))")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store1"), 1),
                            rank=0, world_size=1)
    out, launches = {}, {}
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
        ops.reset_launch_counts()
        models, s = timed(lambda: api.fit_classes(classes, psi=PSI, backend="sharded",
                                                  mesh=mesh))
        launches["classes"] = ops.launch_counts()
        degrees = max(len(m.stats["degrees"]) for m in clf_models)
        _sharded_gates("13a classes", models, clf_models, launches["classes"],
                       {"gram_update_acc_batched": degrees, "ihb_degree_batched": degrees})
        out["classes"] = dict(s=s, degrees=degrees, all_reduces=models[0].stats["all_reduces"],
                              all_reduce_s=models[0].stats["all_reduce_seconds"])
        local0, local0_s = timed(lambda: api.fit(classes[0], psi=PSI))
        ops.reset_launch_counts()
        one, s = timed(lambda: api.fit(classes[0], psi=PSI, backend="sharded", mesh=mesh))
        launches["class0"] = ops.launch_counts()
        d = len(local0.stats["degrees"])
        _sharded_gates("13a class 0", [one], [local0], launches["class0"],
                       {"gram_update_acc": d, "ihb_degree": d})
        out["class0"] = dict(s=s, local_s=local0_s, degrees=d,
                             all_reduce_s=one.stats["all_reduce_seconds"])
        src = planted_stream(SCALE_ROWS[1])
        local_st, local_st_s = timed(lambda: api.fit(src, psi=PSI, chunk_rows=65536))
        ops.reset_launch_counts()
        st, s = timed(lambda: api.fit(src, psi=PSI, chunk_rows=65536, backend="sharded",
                                      mesh=mesh))
        launches["stream"] = ops.launch_counts()
        _sharded_gates("13a stream", [st], [local_st], launches["stream"],
                       {"gram_update_acc": st.stats["streaming"]["num_chunks"],
                        "ihb_degree": len(st.stats["degrees"])})
        out["stream"] = dict(s=s, local_s=local_st_s, chunks=st.stats["streaming"]["num_chunks"],
                             degrees=len(st.stats["degrees"]),
                             all_reduce_s=st.stats["all_reduce_seconds"])
    finally:
        dist.destroy_process_group()
    torch.cuda.synchronize()
    log(f"  13a: bit-identical to the local card fits, one all_reduce a degree: {out}; "
        f"launches {launches}")
    return out, launches


def two_ranks_one_card(X0, local, local_s, tmp):
    """13b: two ranks on the one card under gloo (spawned processes) fit
    class 0 at paper scale: identical models on both ranks, the local card
    fit's structure, the float64-witness rule."""
    import subprocess

    log("phase 13b: class 0 of the phase-3 split on two ranks of the one card (gloo, "
        "CUDA tensors staged through the host)")
    work = os.path.join(tmp, "ranks")
    os.makedirs(work)
    np.save(os.path.join(work, "X0.npy"), X0)
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", RANK_PROGRAM, str(r), "2", work], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        errs = [p.communicate(timeout=240)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    if any(p.returncode for p in procs):
        raise AssertionError(f"13b: a rank failed: {[e[-2000:] for e in errs]}")
    ranks = []
    for r in range(2):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            info = json.load(f)
        coeffs = np.load(os.path.join(work, f"rank{r}.npz"))
        info["coeffs"] = [coeffs[f"g{i}"] for i in range(len(info["gens"]))]
        ranks.append(info)
    a, b = ranks
    if (a["terms"], a["gens"]) != (b["terms"], b["gens"]) or not all(
            x.tobytes() == y.tobytes() for x, y in zip(a["coeffs"], b["coeffs"])):
        raise AssertionError("13b: the two ranks' models differ")
    for r in ranks:
        d = len(r["degrees"])
        if r["all_reduces"] != d or r["launches"]["gram_update_acc"] != d:
            raise AssertionError(f"13b: rank launches {r['launches']}, all_reduces "
                                 f"{r['all_reduces']} for {d} degrees")
    if [list(t) for t in local.book.terms] != a["terms"] or \
            [list(g.term) for g in local.generators] != a["gens"]:
        raise AssertionError("13b: structure differs from the local card fit")
    witness = lstsq_coeffs(local, X0)
    err_ranks = max((float(np.abs(c - w).max()) for c, w in zip(a["coeffs"], witness)),
                    default=0.0)
    err_local = _coeff_err([local], [witness])
    limit = max(FIT_ERR_FACTOR * err_local, FIT_ERR_FLOOR)
    if err_ranks > limit:
        raise AssertionError(f"13b: coefficients {err_ranks:.3g} from the float64 witness, "
                             f"over {limit:.3g}")
    out = dict(wall_s=wall, rank_fit_s=[r["s"] for r in ranks], local_s=local_s,
               all_reduce_ms=[1e3 * r["all_reduce_s"] for r in ranks],
               all_reduces=a["all_reduces"], m_padded=a["m_padded"],
               launches=[r["launches"] for r in ranks], err_ranks=err_ranks,
               err_local=err_local, device=a["device"])
    log(f"  13b: both ranks bit-identical, the local structure, witness distance "
        f"{err_ranks:.3g} (local {err_local:.3g}, limit {limit:.3g}); rank fits "
        f"{out['rank_fit_s']} s against the local {local_s:.3f} s, all_reduce "
        f"{out['all_reduce_ms']} ms in all ({a['all_reduces']} a rank); {wall:.1f} s with "
        f"process start-up")
    return out, {f"rank{r}": ranks[r]["launches"] for r in range(2)}


def main_path_distributed(clf, paper_data):
    """Phase 13: data-parallel OAVI on the card."""
    import tempfile

    from repro_torch import api

    t0 = time.perf_counter()
    Xtr, ytr = paper_data[:2]
    Xs = clf.scaler.transform(Xtr)
    classes = [Xs[ytr == c] for c in clf.classes_]
    with tempfile.TemporaryDirectory() as tmp:
        one, launches = world_of_one(classes, clf.models, tmp)
        local, local_s = timed(lambda: api.fit(classes[0], psi=PSI))
        two, two_launches = two_ranks_one_card(classes[0], local, local_s, tmp)
    launches.update(two_launches)
    out = dict(world_of_one=one, two_ranks=two, seconds=time.perf_counter() - t0)
    log(f"  phase 13: {out['seconds']:.1f} s")
    return out, launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # full fp32 plain versions
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    log("phase 1: card and toolchain")
    log(f"  {smi}; torch {torch.__version__}, torch.version.cuda {torch.version.cuda}")
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], check=True,
                          capture_output=True, text=True).stdout.strip().splitlines()
    log(f"  {nvcc[-2]} / {nvcc[-1]}")
    t0 = time.perf_counter()
    _build.library()
    from repro_torch.obs import device as obs_device

    log(f"  kernels built in {time.perf_counter() - t0:.2f} s (obs.device.compile_snapshot: "
        f"{obs_device.compile_snapshot()})")
    for src, text in _build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "Compiling entry" in line:
                log(f"  {src}: {line.strip()}")

    log("phase 2: kernels against their plain versions on the card")
    gacc = check_gram_acc(dev, 2_000_000, 64, 3, 64, split_blocks=3001, reps=10)
    gacc_wide = check_gram_acc(dev, 4608, 2048, 57, 2048, split_blocks=7, reps=3)
    gupd = check_gram_update(dev, 2_000_000, 64, 3, 64, reps=10)
    ihb = {L: check_ihb(dev, L, steps=min(32, L // 4), reps=50) for L in (64, 512, 2048)}
    degree = {shape: check_ihb_degree(dev, *shape, reps=reps)
              for shape, reps in (((64, 4, 40, 64), 20), ((2048, 1, 57, 64), 20),
                                  ((2048, 58, 1653, 2048), 5),
                                  ((2048, 1024, 512, 512), 5))}
    # the class axis, at the shapes of the class-batched main paths
    gacc_b = check_gram_batched(dev, 2, 1 << 20, 64, 3, 64, reps=10)
    gacc_b_wide = check_gram_batched(dev, 2, 4096, 2048, 57, 2048, reps=3)
    ihb_b = {L: check_ihb_update_batched(dev, L, 2, reps=50) for L in (64, 2048)}
    degree_b = {"paper": check_ihb_degree_batched(dev, 64, 64, [(4, 6), (4, 6)], reps=20),
                "spam": check_ihb_degree_batched(dev, 2048, 2048, [(58, 1653), (58, 1653)],
                                                 reps=5)}

    launches, paper, paper_data, paper_clf = main_path_paper_scale()
    wide_launches, wide, wide_fast = main_path_wide()

    log("phase 5: flash_attention against its plain version on the card (bf16)")
    flash = {
        "serve": check_flash(dev, "serve shape", 4, 32, 8, 2048, 2048, 128, 128, True, 20),
        "ragged_causal": check_flash(dev, "ragged causal", 4, 32, 8, 2000, 2000, 128, 128,
                                     True, 10),
        "ragged_noncausal": check_flash(dev, "non-causal, ragged Sk", 4, 32, 8, 2048, 1999,
                                        128, 128, False, 10),
        "mla_dv": check_flash(dev, "dv != d", 4, 16, 16, 2048, 2048, 192, 128, True, 10),
    }
    if flash["serve"]["variant"] != "wgmma":
        raise AssertionError(f"the serve shape took the {flash['serve']['variant']} variant, "
                             "not wgmma")
    serve_launches, lm = main_path_serve(dev)
    oracle_launches, oracle = main_path_oracles(paper_data, wide_fast)
    abm_launches, gram3, baselines = main_path_baselines(dev, paper_data, wide_fast[0])
    batch_launches, class_batched = main_path_class_batch(paper_data)
    stream_kernels, stream_launches, streamed = main_path_streaming(dev)
    serving = main_path_serving(paper_clf, paper_data, wide_fast)
    continuous, loop_launches = main_path_continuous()
    distributed, dist_launches = main_path_distributed(paper_clf, paper_data)

    src = "src/repro_torch/kernels/csrc/"
    kernels = [
        # one-class fits (api.fit; phase 4's wide fit) launch the one-class
        # entries; the multi-class main paths (phases 3, 9) the batched ones
        dict(name="gram_update_acc", route="cuda", source=src + "gram_update.cu",
             replaces="src/repro/kernels/gram_update.py:118",
             launches=wide_launches["gram_update_acc"], **gacc_wide),
        dict(name="gram_update_acc (class-batched)", route="cuda",
             source=src + "gram_update.cu", replaces="src/repro/kernels/gram_update.py:118",
             launches=launches["gram_update_acc_batched"], **gacc_b),
        # ABM's degree step (phase 8a), checked at the shape it gave the kernel
        dict(name="gram_update", route="cuda", source=src + "gram_update.cu",
             replaces="src/repro/kernels/gram_update.py:77",
             launches=abm_launches["gram_update"], **gram3),
        # the paper's oracle path launches the single in-place update (L = 64
        # at paper scale), the fast engine's path the degree loop's kernel
        dict(name="ihb_update", route="cuda", source=src + "ihb_update.cu",
             replaces="src/repro/kernels/ihb_update.py:52",
             launches=oracle_launches["ihb_update"], entry="ihb_update (oracle path)",
             **ihb[64],
             ihb_degree=dict(launches=wide_launches["ihb_degree"],
                             **degree[(2048, 58, 1653, 2048)])),
        dict(name="ihb_update (class-batched)", route="cuda", source=src + "ihb_update.cu",
             replaces="src/repro/kernels/ihb_update.py:52",
             launches=batch_launches["cgavi-ihb"]["ihb_update_batched"], **ihb_b[64]),
        dict(name="ihb_degree (class-batched)", route="cuda", source=src + "ihb_update.cu",
             replaces="src/repro/kernels/ihb_update.py:52",
             launches=batch_launches["9c"]["ihb_degree_batched"], **degree_b["spam"]),
        # the streamed fit (phase 10b): one carried Gram launch a chunk, and
        # the fast engine's degree loop once a degree; the streamed oracle
        # path (10a, cgavi-ihb) launches the single update a candidate
        dict(name="gram_update_acc (streaming, carry per chunk)", route="cuda",
             source=src + "gram_update.cu", replaces="src/repro/kernels/gram_update.py:118",
             launches=stream_launches["paper"]["gram_update_acc"], **stream_kernels["gram_chunk"]),
        dict(name="ihb_update (streaming)", route="cuda", source=src + "ihb_update.cu",
             replaces="src/repro/kernels/ihb_update.py:52",
             launches=stream_launches["paper"]["ihb_degree"], entry="ihb_degree (fast path)",
             **stream_kernels["degree"],
             ihb_update=dict(launches=stream_launches["cgavi-ihb"]["ihb_update"], **ihb[64])),
        dict(name="flash_attention", route="cuda", source=src + "flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:81",
             launches=serve_launches["flash_attention"], **flash["serve"]),
    ]
    for entry in kernels:
        nested = [v["launches"] for v in entry.values() if isinstance(v, dict) and "launches" in v]
        if min([entry["launches"]] + nested) <= 0:
            raise AssertionError(f"{entry['name']}: no launch on its main path")
    log("wide shapes: " + json.dumps({
        "gram_update_acc_m2M": gacc,
        "gram_update_m2M": gupd,
        "ihb_update": {L: ihb[L] for L in (512, 2048)},
        "ihb_degree": {"x".join(map(str, k)): v for k, v in degree.items()},
        "launches_wide_fit": wide_launches,
        "wide_fit": wide,
        "paper_scale": paper,
        "flash_attention": {k: v for k, v in flash.items() if k != "serve"},
        "serve_qwen3_8b": lm,
        "oracle_variants": oracle,
        "baselines": baselines,
        "class_batched_kernels": {"gram_update_acc_wide": gacc_b_wide,
                                  "ihb_update_L2048": ihb_b[2048],
                                  "ihb_degree_paper": degree_b["paper"]},
        "class_batched_fits": class_batched,
        "streaming_kernels": {"gram_chunk_65536": stream_kernels["gram_chunk_65536"]},
        "streaming": streamed,
        "serving": serving,
        "continuous": continuous,
        "distributed": distributed,
    }, default=str))
    # the launches of phases 12-13's paths, each read after its own run with
    # the counts set to 0 before it (the ranks of 13b count in their processes)
    paths = {"12a continuous_vi": loop_launches,
             **{f"13a {k}": v for k, v in dist_launches.items() if not k.startswith("rank")},
             **{f"13b {k}": v for k, v in dist_launches.items() if k.startswith("rank")}}
    for path, counts in paths.items():
        if not (counts.get("gram_update_acc", 0) or counts.get("gram_update_acc_batched", 0)):
            raise AssertionError(f"{path}: no Gram launch on its path")
    log(json.dumps({"launches_by_path": paths}))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(nvidia_smi_line())
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
