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
   The fused FISTA step of the SVM head (``fista_step``) at the paper-scale
   head's shape (1,200,000 x 12, k = 2) against the eager loop on the same
   tensors (the same steps, W and b within FISTA_TOL, two runs bit for bit),
   timed with CUDA events and on the device beside its bound and the eager
   step.
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
   length and dv != d, and the shapes of phases 15-16's paths (Kimi-K2's
   and Jamba's GQA 64/8, MLA's train shape, Qwen2-VL's GQA 12/2, HuBERT's
   non-causal d = 80), and one bf16 shape of the scalar variant (the
   reduced configs' (24, 16), ragged); the bf16 plain version's own error
   beside it; each timed beside its bound, the plain version and PyTorch's
   ``scaled_dot_product_attention``.  Each shape logs the kernel variant it
   took; the serve shape and HuBERT's must take the wgmma one, the (24, 16)
   shape the scalar one.
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
   streamed ``fast`` fit at m = 131,072, 2,097,152 and 8,388,608 (seconds,
   chunks, peak device bytes within 1.5x across the sweep), at 8,388,608
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
   validated and rendered by ``launch.obs_report``; (f) the sharded engine
   (``TransformEngine(mesh=[cuda:0] * k)``, k = 2 and 4, and one span a card
   where there are several) over the phase-3 classifier, 256 requests
   bit-equal to the local engine's, then ``serve_vi --sharded --mesh-shape
   k`` replays beside the local one.
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
14. LM training (``launch.train``, Qwen2-1.5B, hf:Qwen/Qwen2-1.5B): (a) 8
   steps at full width (28 layers, batch 4 x 1,024 tokens, AdamW with fp32
   moments, remat full): the median step time over steps 2-8, tokens/s,
   peak memory, the idle share of one profiled step, and the
   ``flash_attention`` launches of the run, which must be two a layer a
   step (the forward and its remat recompute: a plain-attention fallback
   would make none); then three steps on one batch that descend; (b) at full
   width cut to 2 periods, the loss and every gradient through the kernel
   and with ``use_kernel=False``, each leaf no further from an fp32 copy's
   than twice the plain path's, every attention weight's gradient non-zero;
   (c) 8-bit moments: 6 steps checkpointed every 3, a resume to step 9, its
   losses against an uninterrupted run's; (d) the chunked CE against the
   plain one at full vocabulary, each with its peak memory.

15. MLA and MoE (``models/mla.py``, ``models/moe.py``): (a) ``launch.serve.serve``
   of DeepSeek-V2-Lite at full width and depth (27 x (mla, moe), bf16, random
   weights from seed 0), batch 4 x 2,048 prompt tokens, 32 generated: the
   prefill must launch ``flash_attention`` 27 times, on the wgmma variant at
   d = 192 / dv = 128; the same weights rebuilt give the same first tokens,
   a second prefill the same bits; one prefill and one decode step profiled,
   device time grouped as the flash kernel, the router, dispatch/combine, the
   expert ``bmm`` and the rest; (b) the kernel run's logits against
   ``use_kernel=False`` with the routes pinned to the kernel run's (a test
   harness at ``moe.route``: with random weights the router is near-uniform
   and the two bf16 runs pick other experts for some tokens): at full depth
   the gap is printed, at full width cut to 4 periods the ``LM_FACTOR`` rule
   of phase 6 against an fp32 copy is applied; the unpinned share of tokens
   routed elsewhere is printed by layer; (c) Kimi-K2 at full width cut to one
   period of 61 (1.04 T parameters do not fit one card), batch 4 x 2,048,
   8 generated: one ``flash_attention`` launch (GQA 64/8, wgmma), finite
   logits, every kept (token, choice) pair in a slot of its own, the dropped
   share and peak memory; (d) three ``make_train_step`` steps of
   DeepSeek-V2-Lite at full width and 2 periods on one batch of 4 x 1,024,
   remat full: finite losses that fall, aux > 0, two ``flash_attention``
   launches a layer a step.
16. The SSM, hybrid, VLM and audio families (``models/ssm.py``, M-RoPE, the
   frames frontend), bf16, random weights from seed 0: (a) ``serve`` of
   xLSTM-1.3B at full width and depth (6 x (7 mLSTM + 1 sLSTM)), batch 4 x
   2,048, 32 generated: the rebuilt weights give serve's tokens, a second
   prefill the same bits; the decode step and one period's prefill profiled
   (launches, busy and idle shares), each layer kind timed; at full width cut
   to 1 period in fp32 (B = 1 x 256) the card's logits against the CPU
   port's (``CARD_CPU_TOL``) and token-by-token decode from ``init_cache``
   against forward; (b) ``serve`` of Jamba-1.5-Large's first 5 layers
   (period[:10]: 4 Mamba, 1 attention, 3 MLP, 2 MoE) at full width, batch
   4 x 2,048, 8 generated: one ``flash_attention`` launch, unique MoE slots,
   a repeated prefill's bits, each layer's device ms; the ``LM_FACTOR`` rule
   with routes pinned at a further cut (a Mamba + MoE layer and the
   attention + MLP layer, the fp32 copy built after the bf16 runs); (c)
   phase 6's path for Qwen2-VL-2B (28 layers, text-mode M-RoPE, GQA group 6
   on the wgmma variant); (d) HuBERT-XLarge's encoder at full width and depth
   on 4 x 1,500 frames of ``frame_embeddings(seed=0)``: 48 launches of the
   wgmma variant at d = 80, non-causal, its share of device time, the
   ``LM_FACTOR`` rule over every frame's logits; three ``make_train_step``
   steps at 4 periods on frames and labels (losses falling, two launches a
   layer a step).
17. The dry run and the sharding layer (``get_optimized``, the mesh): (a)
   ``serve`` of ``get_optimized("qwen3-8b")`` (chunked attention, chunks of
   1,024) at phase 6's shape; its prefill logits held against phase 6's
   flash-path logits from the same seed-0 weights by the ``LM_FACTOR`` rule
   (phase 6's fp32 copy the witness), no flash launch in its prefill, and
   the chunked and flash prefills timed in turns on the same weights; (b)
   ``get_optimized("deepseek-v2-lite-16b")`` at full width and depth
   (chunked MLA at d = 192 / dv = 128, rowwise MoE with one row) with the
   routes pinned to phase 15a's: its prefill logits no further from 15a's
   flash logits than ``LM_FACTOR`` times 15a's plain-attention gap; (c)
   ``python -m repro_torch.launch.dryrun`` on Qwen3-8B's train_4k,
   prefill_32k and decode_32k and ``--oavi``, in a subprocess that must not
   initialize CUDA: each Qwen3-8B cell's FLOP count equal to its products
   counted by hand, the OAVI step's all-reduce (L K + K K) fp32 words (the
   whole grid, whose SSM cells take minutes of host time, is left to the
   CLI and the CPU tests); (d)
   ``launch.train.train`` of Qwen2-1.5B cut to 2 periods, 2 steps of 4 x
   1,024, under ``make_local_mesh()`` (an NCCL world of one) and with no
   mesh, deterministic algorithms on: the losses bit for bit equal.
18. LM serving and training over two ranks (``runtime/data_parallel.py``,
   ``serve(mesh=)``, ``make_sharded_train_state`` / ``make_step``, the MoE
   across ranks): two gloo ranks on the one card (spawned processes; NCCL
   refuses two ranks on one device), a (data 2, model 1) mesh, each held
   against a one-device run in this process: (a) ``serve`` of Qwen2-1.5B at
   full width and depth, batch 4 x 1,024 prompt tokens, 32 generated, two
   rows a rank: each rank's prefill logits within ``LM_FACTOR`` of the
   one-device run's rows, one flash launch a layer a rank, the generated
   tokens that differ reported; (b) Qwen2-1.5B cut to 2 periods, 3 steps of
   4 x 1,024 with the parameters and fp32 moments cut by ``param_specs`` /
   ``state_specs``: the ranks' losses and the leaves they hold whole
   bit-equal, the losses within ``MESH_LOSS_RTOL`` of one device's and the
   parameters within ``MESH_PARAM_RTOL`` of one device's (relative to how
   far its steps moved them), two flash launches a layer a step,
   ``memory_allocated`` between steps within 5% of the plan's at-rest
   bytes, the collectives issued equal to the plan's, step and collective
   seconds (gloo through the host); (c) DeepSeek-V2-Lite cut to 2 periods,
   2 steps, the one-device run's routes replayed: the aux loss and the
   global dispatch plan over both ranks, the same gates on its losses and
   parameters.  Controls that must fail the gates: each run again on the
   ranks with every sharded gradient left unreduced (a rank's own block of
   its own gradient), and 18b's cut on one device at learning rate 0.
   18b-c's optimizer takes no warm-up step, so every step after the first
   reads an update.  Each period's sharded leaves are gathered inside the
   period (again by its remat recompute) and their gradients
   reduce-scattered as its backward ends: (d) Qwen2-1.5B at full
   width and depth, 2 steps of 2 x 1,024 tokens, 18b's gates against one
   device, each step's ``max_memory_allocated`` above its start against
   ``step_peak_prediction`` (the plan's ``held_bound`` and the
   activations), the plan's held-bytes count against its bound, and the
   whole-gather step's figure logged beside them; (e) DeepSeek-V2-Lite at
   full width cut to the fewest periods at which, by the plans' bytes, two
   ranks of the whole-gather step do not fit the card and two of the
   per-period step fit with 15% to spare (``fit_periods``), one step, the
   same gates without one device's run.
19. Tensor parallelism (``runtime/tensor_parallel.py``, a ``model`` axis of
   2: heads, FFN columns, experts and the vocabulary cut over it, Megatron's
   ``f`` / ``g``): gloo ranks on the one card, held against one-device runs:
   (a) ``serve`` of Qwen3-8B at full width cut to 12 of its 36 layers on
   (data 1, model 2), batch 4 x 1,024 prompt tokens, 32 generated (PR 27
   served all 36: phase 20 shares the time limit): 12 flash launches a rank at
   16/4 heads, the gathered logits within ``LM_FACTOR`` of the fp32 copy,
   the tokens that differ reported, the weight bytes a rank holds against
   the plan's; then the same cut weights' decode fed one device's tokens
   (teacher forcing), every step's gathered logits within ``LM_FACTOR`` of
   the fp32 copy's; (b) 18b's cut, 3 steps on (1, 2) and (2, 2), 18b's
   gates, the collectives equal to the plan's (model axis included), with
   two controls that must fail them (the model axis's sum of partial
   gradients left out; a sum added where every rank holds the whole
   gradient); (c) 18c's cut on (1, 2), 32 experts and 8 MLA heads a rank,
   routes replayed, 18c's gates, with the sum left out as its control; then
   the cut in fp32 on the ranks and on one device, held far closer (each
   leaf's parameters within ``TP_FP32_PARAM_RTOL``), with two controls of
   the aux loss (counted twice in the loss and its gradient; counted once
   in the loss, its gradient twice).
20. Tensor parallelism for the SSM mixers, the frames frontend and 8-bit
   moments, on (data 1, model 2) gloo ranks on the one card, held against
   one-device runs: (a) ``serve`` of xLSTM-1.3B at full width cut to 3 of
   its 6 periods (the script's time limit; 16a serves all 6),
   batch 4 x 1,024, 16 generated (2 of 4 mLSTM and sLSTM heads a rank): the
   gathered logits and the decode fed one device's tokens within
   ``LM_FACTOR`` of the fp32 copy, the weight bytes a rank holds against the
   plan, its recurrent state one device's with its heads halved; then 2
   steps of its 1-period cut at 4 x 256 (held within ``LM_FACTOR`` of bf16's
   own distance from an fp32 run of the same initial weights: xLSTM's bf16
   steps are too noisy for 18-19's fixed limits); (b) Jamba-1.5-Large at
   full width cut to one Mamba and the attention layer with their MLPs (2.9
   B parameters), served as (a) (1 flash launch a rank at 32/4 heads) and
   trained 2 steps of 2 x 1,024; (c) HuBERT-XLarge at 4 periods, 3 steps on
   frames (8 heads of 80 a rank, 252 classes); (d) 19b's cut with 8-bit
   moments (whole on every rank), 3 steps.  18-19's gates on (b-d); (a-c)
   again in fp32 with 19c's fp32 gates (every leaf), and two controls in
   fp32 that must fail them (Mamba's ``xin @ w_x`` summed by ``g`` alone;
   the sLSTM's ``r`` gradient left unsummed).

Every check that fails raises, and the script exits non-zero before its last
line.  It needs a CUDA card and the repository's ``src/`` beside it.  The last
lines are the kernels' JSON record, the ``nvidia-smi`` name and power limit,
and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
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
# fused FISTA step vs the eager loop: the same float32 update, the gradient
# summed in another order (the kernel's rows, shuffle tree, warps and block
# partials in float64 against cuBLAS); a few hundred accelerated steps carry
# that to ~1e-5 of max|W| (tests/test_torch_gpu_fista.py)
FISTA_TOL = 1e-4
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


def device_ms(fn, kernel: str, reps: int, traces: int = 3) -> float:
    """Milliseconds of device time per launch of the kernel whose name
    contains ``kernel``, over ``reps`` calls of ``fn`` under
    ``torch.profiler``: what the card spends, where a host-bound loop's
    CUDA-event time measures the host.  A trace must hold exactly ``reps``
    launches.  The profiler's activity buffers can lose an event of a
    microsecond-long kernel (one trace held 49 of 50), so a trace short of
    launches is taken again, up to ``traces`` times, and never used."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    counts = []
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [ev for ev in prof.key_averages()
                if ev.device_type == DeviceType.CUDA and kernel in ev.key]
        count = sum(ev.count for ev in rows)
        if count == reps:
            if counts:
                log(f"  device_ms({kernel}): traces held {counts} launches of {reps} before "
                    "this one; those traces were discarded")
            return sum(ev.self_device_time_total for ev in rows) / 1e3 / count
        counts.append(count)
    raise AssertionError(f"profiled {counts} launches of {kernel} in {traces} traces, "
                         f"expected {reps}")


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


def check_fista_step(dev, m, p, k, steps, reps):
    """The fused FISTA step at the SVM head's shape: ``steps`` steps of the
    kernel's loop against the eager loop on the same tensors, twice for its
    bits; then one step timed (CUDA events over back-to-back launches, and on
    the device) beside its bound (X and the class bytes read once) and the
    eager step (a 32-step block of the eager loop, with its stop test)."""
    import torch

    from repro_torch.core import svm
    from repro_torch.kernels import fista_step, ref

    rng = np.random.default_rng(m + p + k)
    Xh = rng.uniform(0, 1, (m, p)).astype(np.float32)
    w = rng.standard_normal((p, k))
    yh = np.argmax(Xh @ w + 0.3 * rng.standard_normal((m, k)), axis=1).astype(np.int8)
    X, labels = torch.from_numpy(Xh).to(dev), torch.from_numpy(yh).to(dev)
    Y = ref.class_signs_ref(labels, k, X.dtype)
    lam = torch.tensor(1e-4, dtype=torch.float32, device=dev)
    never = torch.tensor(-1.0, dtype=torch.float32, device=dev)  # delta >= 0: no tol stop
    step = svm._step_size(X)
    tag = f"fista_step m={m} p={p} k={k}, {steps} steps"
    got = svm._fista_fused(X, labels, k, lam, step, steps, never)
    again = svm._fista_fused(X, labels, k, lam, step, steps, never)
    want = svm._fista(X, Y, lam, step, steps, never)
    if not int(got[2]) == int(want[2]) == steps:
        raise AssertionError(f"{tag}: steps {int(got[2])} (eager {int(want[2])})")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{tag}: two runs differ")
    scale = float(want[0].abs().max())
    err = max(check_close(f"{tag} W", got[0], want[0], 0.0, FISTA_TOL * scale),
              check_close(f"{tag} b", got[1], want[1], 0.0, FISTA_TOL * scale))
    run = fista_step.FistaStep(X, labels, k, step, lam, never, 1 << 30)
    ms = time_ms(lambda: run.run(1), reps)
    block_ms = time_ms(lambda: run.run(svm.CHECK_EVERY), max(1, reps // svm.CHECK_EVERY))
    dev_ms = device_ms(lambda: run.run(1), "fista_step_kernel", reps)
    eager_ms = time_ms(lambda: svm._fista(X, Y, lam, step, svm.CHECK_EVERY, never),
                       3) / svm.CHECK_EVERY
    b_ms, b_by = bound(4.0 * m * p * k + 4.0 * m * k, m * (4.0 * p + 1.0))
    log(f"  {tag}: two runs bit-identical; kernel {ms:.4f} ms a step ({block_ms / 32:.4f} "
        f"ms in 32-step blocks, grid {run.grid}), of it on the device {dev_ms:.4f} ms; eager "
        f"{eager_ms:.4f} ms a step; bound {b_ms:.6f} ms ({b_by})")
    return dict(max_abs_err=err, ms=ms, block_ms_per_step=block_ms / 32, device_ms=dev_ms,
                plain_ms=eager_ms, bound_ms=b_ms, bound_by=b_by, grid=run.grid,
                shape=dict(m=m, p=p, k=k))


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
    # the SVM head: one fused step a FISTA step, none past max_iter
    iters, max_iter = s["svm"]["iters"], clf.config.svm.max_iter
    if not (iters <= launches["fista_step"] < iters + 32
            and (iters < max_iter or launches["fista_step"] == iters)):
        raise AssertionError(f"fista_step launched {launches['fista_step']} times for "
                             f"{iters} FISTA steps")
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


def main_path_serve(dev, arch="qwen3-8b", phase="6", keep=None):
    """``serve`` of a dense GQA model at full width and depth (phase 6:
    Qwen3-8B; 16c: Qwen2-VL-2B, text-mode M-RoPE), then the same weights'
    logits against plain attention and an fp32 copy.  ``keep`` (a dict)
    receives the prefill's last-token logits of the kernel path and the
    fp32 copy on the host, for phase 17a."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import variant
    from repro_torch.launch.serve import serve
    from repro_torch.models.model import Transformer

    cfg = configs.get_config(arch)
    batch, prompt_len, gen_tokens = 4, 2048, 32
    n_attn = cfg.n_periods * cfg.period.count("attn")
    kind = variant(torch.bfloat16, cfg.d_head, cfg.d_head)
    log(f"phase {phase}: serve {cfg.name} at full width ({cfg.n_periods} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.d_head} (group "
        f"{cfg.n_heads // cfg.n_kv_heads}, flash variant {kind}), M-RoPE sections "
        f"{cfg.mrope_sections}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}, "
        f"{_param_count(cfg):,} parameters), batch {batch}, prompt {prompt_len}, "
        f"{gen_tokens} generated tokens, seed 0")
    if kind != "wgmma":
        raise AssertionError(f"{phase}: the prefill's attention takes the {kind} variant")
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
    if keep is not None:
        keep.update(flash=lk[:, -1].float().cpu(), fp32=l32[:, -1].float().cpu(),
                    plain_vs_fp32=pre["plain_vs_fp32"], prefill_s=out["prefill_s"])
    torch.cuda.empty_cache()
    return launches, dict(prefill_s=out["prefill_s"], decode_s=out["decode_s"],
                          tokens_per_s=out["tokens_per_s"], serve_s=serve_s,
                          peak_memory_gb=peak_gb, prefill_logits=pre, decode_logits=dec,
                          profile=prof, variant=kind)


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
# the reference streaming benchmark's sweep (benchmarks/bench_streaming.py)
# spans 128x, up to >= 1e7 rows; the script's time limit stops it at 2^23
# rows (64x): its largest m costs ~60 s here at 2^24 (10c's three fits, 10d)
SCALE_ROWS = (131_072, 2_097_152, 8_388_608)
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


SHARDED_REQUESTS = 256


def serve_sharded(clf, tmp):
    """11f: phase 3's classifier through the sharded engine: k spans of the
    one card (k = 2, 4; with several cards, one span a card too), every
    reply held against the local engine's bit for bit; then a
    ``serve_vi --sharded`` replay of 256 requests beside the local one."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import serve_vi
    from repro_torch.serving import EngineConfig, TransformEngine

    path = os.path.join(tmp, "clf")  # saved by 11a
    sizes = serve_vi.synth_trace(SHARDED_REQUESTS, 128, 0)
    payloads = serve_vi.make_payloads(clf.scaler.transform, sizes, 0)
    cfg = EngineConfig(min_bucket=64, max_bucket=16_384)
    local = TransformEngine(clf.models, config=cfg)
    local.warmup()
    want = [local.transform(p) for p in payloads]
    dev = local.device
    meshes = {f"{k} spans of {dev}": [dev] * k for k in (2, 4)}
    cards = torch.cuda.device_count()
    if cards > 1:
        meshes[f"{cards} cards"] = [torch.device("cuda", i) for i in range(cards)]
    log(f"phase 11f: the sharded engine over phase 3's classifier ({len(clf.models)} models, "
        f"{local.terms} terms), {SHARDED_REQUESTS} requests of synth_trace(mean_rows=128, "
        f"seed=0) on {', '.join(meshes)}; {cards} visible card(s)")
    launches0 = ops.launch_counts()
    out = {"meshes": {}}
    for tag, mesh in meshes.items():
        eng = TransformEngine(clf.models, mesh=mesh, config=cfg)
        eng.warmup()
        for i, p in enumerate(payloads):
            if not np.array_equal(eng.transform(p), want[i]):
                raise AssertionError(f"11f {tag}: reply {i} differs from the local engine's")
        st = eng.stats
        out["meshes"][tag] = dict(shards=eng.shards, buckets=list(eng.buckets()),
                                  device_calls=st["device_calls"],
                                  padded_rows=st["padded_rows"],
                                  lat_p50_ms=st["latency"]["p50"] * 1e3,
                                  lat_p99_ms=st["latency"]["p99"] * 1e3)
        log(f"  {tag}: {SHARDED_REQUESTS} replies bit-equal to the local engine's; "
            f"{st['device_calls']} device calls, {st['padded_rows']} padded rows (local "
            f"{local.stats['padded_rows']}), engine p50 {st['latency']['p50'] * 1e3:.3f} ms "
            f"p99 {st['latency']['p99'] * 1e3:.3f} ms (local p50 "
            f"{local.stats['latency']['p50'] * 1e3:.3f} p99 "
            f"{local.stats['latency']['p99'] * 1e3:.3f} ms)")
    args = ["--model-dir", path, "--kind", "transform", "--requests", str(SHARDED_REQUESTS),
            "--mean-rows", "128", "--concurrency", "8", "--max-delay-ms", "2",
            "--max-batch-rows", "8192"]
    shapes = [("local", [])] + [(f"--sharded --mesh-shape {k}", ["--sharded", "--mesh-shape",
                                                                  str(k)]) for k in (2, 4)]
    for tag, extra in shapes:
        replies = []
        rep = serve_vi.main(args + extra, replies=replies)
        for i, r in enumerate(replies):
            if not np.array_equal(r, want[i]):
                raise AssertionError(f"11f serve_vi {tag}: reply {i} differs from local")
        out[tag] = serve_summary(f"serve_vi {tag} ({rep['shards']} spans)", rep, local.terms)
        out[tag]["shards"] = rep["shards"]
    if ops.launch_counts() != launches0:
        raise AssertionError("11f: serving launched a hand-written kernel")
    return out


def main_path_serving(clf, paper_data, wide_fast):
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        out = serve_paper_scale(clf, paper_data[2], tmp)
        out["wide"] = serve_wide(wide_fast, tmp)
        out["fit_obs"] = fit_observed(paper_data, tmp)
        out["sharded"] = serve_sharded(clf, tmp)
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


# ---------------------------------------------------------------------------
# Phase 14: LM training
# ---------------------------------------------------------------------------

TRAIN_ARCH = "qwen2-1.5b"
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 8, 4, 1024
# 14b: the kernel path and the plain path differ only in attention's forward
# roundings (the kernel keeps the scores in fp32, the plain version rounds
# them to bf16 before the softmax); the backward is the same plain function.
# How far bf16 moves a gradient at this depth is measured in the run: the
# plain bf16 path's distance from an fp32 copy of the same weights (relative
# Frobenius norm, leaf by leaf).  The kernel path may be no further from
# the fp32 copy than GRAD_FACTOR times that, plus GRAD_FLOOR for leaves
# whose gradient is mostly rounding
GRAD_FACTOR, GRAD_FLOOR = 2.0, 1e-2
# 14c: a resumed run against an uninterrupted one: the embedding's backward
# (index_put with accumulate) adds with atomics in no fixed order, so the
# two runs differ by rounding, carried through Adam steps and int8 moments
RESUME_RTOL = 1e-2
# 14d: chunked against plain CE at full vocabulary: the same bf16 logits
# (each chunk's product tiled anew by cuBLAS, so a logit may move by a bf16
# ulp) reduced in fp32; the loss is ~ln(V) = 11.9
CE_ATOL = 1e-2


def _train_batch(cfg, step=0, seq=TRAIN_SEQ):
    from repro_torch.data import lm as lm_data

    pipe = lm_data.PipelineConfig(vocab_size=cfg.vocab_size, seq_len=seq + 1,
                                  global_batch=TRAIN_BATCH, seed=0)
    return {"tokens": lm_data.batch_for_device(pipe, step, "cuda")}


def _param_count(cfg) -> int:
    from repro_torch.models.model import Transformer

    return sum(p.numel() for p in Transformer(cfg, device="meta", seed=None).parameters())


def train_full_width(dev):
    """14a: ``launch.train.train`` of Qwen2-1.5B at full width, then three
    steps on one batch (one profiled)."""
    import torch

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train
    from repro_torch.models.model import Transformer, make_train_step
    from repro_torch.optim import AdamW

    cfg = configs.get_config(TRAIN_ARCH)
    n_params = _param_count(cfg)
    n_attn = cfg.n_periods * cfg.period.count("attn")
    log(f"phase 14a: launch.train.train({cfg.name} at full width: {cfg.n_periods} layers, "
        f"d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, {cfg.dtype}, {n_params:,} parameters; remat {cfg.remat_policy}, "
        f"ce {cfg.ce_impl}), {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens, "
        "AdamW with fp32 moments, no checkpoint")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rep = train(cfg, steps=TRAIN_STEPS, global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                device="cuda", log_every=1)
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_s = float(np.median(rep["step_seconds"][1:]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    # model FLOPs of a step: 6 N a token for the products (the tied
    # embedding's unembedding included, its gather not), causal attention's
    # two products 3 x 2 x 2 x S/2 x H x dh a token a layer; the remat
    # recompute is not counted
    attn = 6.0 * 2 * 2 * (TRAIN_SEQ / 2) * cfg.n_heads * cfg.d_head * n_attn
    flops = (6.0 * n_params + attn) * tokens
    log(f"  {TRAIN_STEPS} steps in {wall:.3f} s (model init included); step seconds "
        f"{[round(s, 4) for s in rep['step_seconds']]}; median over steps 2-{TRAIN_STEPS} "
        f"{step_s:.4f} s, {tokens / step_s:.1f} tokens/s, model FLOPs "
        f"{flops / step_s / 1e12:.1f} TFLOP/s ({100 * flops / step_s / PEAK_BF16_FLOPS:.1f}% of "
        f"the bf16 peak); peak memory {peak_gb:.2f} GB; losses "
        f"{[round(x, 4) for x in rep['losses']]}; kernel launches {launches}")
    expected = 2 * n_attn * TRAIN_STEPS  # forward + remat recompute, every layer
    if launches["flash_attention"] <= 0 or launches["flash_attention"] != expected:
        raise AssertionError(f"training launched flash_attention {launches['flash_attention']} "
                             f"times, expected {expected}: attention left the kernel")
    if not np.isfinite(rep["losses"]).all():
        raise AssertionError(f"14a: losses not finite: {rep['losses']}")

    log("  three steps on one batch (the second profiled), AdamW(peak_lr=3e-4, "
        "warmup_steps=1)")
    torch.cuda.empty_cache()
    model = Transformer(cfg, device=dev, seed=0)
    opt = AdamW(peak_lr=3e-4, warmup_steps=1, total_steps=10)
    state = [opt.init(dict(model.named_parameters()))]
    step = make_train_step(opt)
    batch = _train_batch(cfg)
    losses = []

    def one():
        loss, state[0] = step(model, state[0], batch)
        losses.append(float(loss))

    prof = profile_device(f"train step ({cfg.name}, {TRAIN_BATCH} x {TRAIN_SEQ})", one,
                          watch=("flash",))
    one()
    # the profiler slows the host's launches, so its wall time overstates
    # the idle share; the busy time against an unprofiled step's is the other
    # reading
    idle_unprofiled = 1 - prof["busy_ms"] / (step_s * 1e3)
    log(f"  losses {losses}; device busy {prof['busy_ms']:.3f} ms of the profiled step's "
        f"{prof['wall_ms']:.3f} ms (idle {100 * (1 - prof['busy_ms'] / prof['wall_ms']):.1f}%) "
        f"and of an unprofiled step's {step_s * 1e3:.3f} ms (idle "
        f"{100 * idle_unprofiled:.1f}%); {prof['launches']} kernel launches a step")
    if not losses[2] < losses[0]:
        raise AssertionError(f"14a: three steps on one batch did not descend: {losses}")
    parts = train_step_parts(model, opt, state[0], batch)
    del model, state
    torch.cuda.empty_cache()
    return launches, dict(steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                          params=n_params, step_seconds=rep["step_seconds"],
                          median_step_s=step_s, tokens_per_s=tokens / step_s,
                          model_tflops=flops / step_s / 1e12, peak_memory_gb=peak_gb,
                          losses=rep["losses"], one_batch_losses=losses,
                          idle_share=1 - prof["busy_ms"] / prof["wall_ms"],
                          idle_share_unprofiled=idle_unprofiled, profile=prof, parts=parts,
                          flash_attention_launches=launches["flash_attention"])


def train_step_parts(model, opt, state, batch):
    """The step's parts timed apart with CUDA events: the loss forward (with
    autograd recording), the loss with every gradient, and the optimizer's
    update on those gradients."""
    import torch

    from repro_torch.models.model import loss_fn

    params = dict(model.named_parameters())
    held = {}

    def forward():
        loss_fn(model, batch)

    def forward_backward():
        held["grads"] = torch.autograd.grad(loss_fn(model, batch), list(params.values()))

    fwd_ms = time_ms(forward, reps=2, warmup=1)
    fb_ms = time_ms(forward_backward, reps=2, warmup=1)
    grads = dict(zip(params, held.pop("grads")))
    opt_ms = time_ms(lambda: opt.update(params, grads, state), reps=2, warmup=1)
    log(f"  the step's parts (CUDA events): loss forward {fwd_ms:.3f} ms, loss + gradients "
        f"{fb_ms:.3f} ms (backward with remat recompute {fb_ms - fwd_ms:.3f} ms), AdamW update "
        f"{opt_ms:.3f} ms ({len(params)} parameters, one at a time)")
    return dict(forward_ms=fwd_ms, forward_backward_ms=fb_ms, optimizer_ms=opt_ms)


def _loss_and_grads(model, batch, use_kernel=None, cfg=None):
    import torch

    from repro_torch.models.model import loss_fn

    params = dict(model.named_parameters())
    loss = loss_fn(model, batch, cfg, use_kernel=use_kernel)
    grads = torch.autograd.grad(loss, list(params.values()))
    return float(loss.detach()), dict(zip(params, grads))


def train_kernel_vs_plain(dev):
    """14b: loss and every gradient at full width, 2 periods, through the
    kernel and with ``use_kernel=False``, beside an fp32 copy."""
    import torch

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models.attention import Attention
    from repro_torch.models.model import Transformer

    cfg = dataclasses.replace(configs.get_config(TRAIN_ARCH), n_periods=2)
    log(f"phase 14b: loss and gradients of {cfg.name} at full width cut to "
        f"{cfg.n_periods} periods, {TRAIN_BATCH} x {TRAIN_SEQ} tokens: kernel path against "
        "use_kernel=False, beside an fp32 copy of the weights")
    model = Transformer(cfg, device=dev, seed=0)
    batch = _train_batch(cfg)
    ops.reset_launch_counts()
    lk, gk = _loss_and_grads(model, batch)
    launched = ops.launch_counts()["flash_attention"]
    lp, gp = _loss_and_grads(model, batch, use_kernel=False)
    if ops.launch_counts()["flash_attention"] != launched or launched != 2 * cfg.n_periods:
        raise AssertionError(f"14b: {launched} kernel launches, expected {2 * cfg.n_periods}")
    model32 = Transformer.from_params(dataclasses.replace(cfg, dtype="float32"),
                                      model.state_dict(), device=dev)
    l32, g32 = _loss_and_grads(model32, batch, use_kernel=False)
    del model32
    torch.cuda.empty_cache()
    worst = dict(ratio=0.0)
    for name in gk:
        ref32 = g32[name].float()
        scale = float(torch.linalg.vector_norm(ref32)) + 1e-30
        dk = float(torch.linalg.vector_norm(gk[name].float() - ref32)) / scale
        dp = float(torch.linalg.vector_norm(gp[name].float() - ref32)) / scale
        dkp = float(torch.linalg.vector_norm(gk[name].float() - gp[name].float())) / scale
        if dk > GRAD_FACTOR * dp + GRAD_FLOOR:
            raise AssertionError(f"14b: {name}: kernel path {dk:.4g} from fp32, plain "
                                 f"{dp:.4g}")
        if dk / (dp + GRAD_FLOOR) >= worst["ratio"]:
            worst = dict(name=name, kernel_vs_fp32=dk, plain_vs_fp32=dp, kernel_vs_plain=dkp,
                         ratio=dk / (dp + GRAD_FLOOR))
    attn_leaves = 0
    for i, blk in enumerate(model.blocks):
        if isinstance(blk, Attention):
            for leaf in ("wq", "wk", "wv", "wo", "bq", "bk", "bv"):
                g = gk[f"blocks.{i}.{leaf}"]
                if g is None or not bool(torch.any(g != 0)):
                    raise AssertionError(f"14b: blocks.{i}.{leaf} got no gradient")
                attn_leaves += 1
    if not abs(lk - l32) <= GRAD_FACTOR * abs(lp - l32) + GRAD_FLOOR:
        raise AssertionError(f"14b: losses kernel {lk}, plain {lp}, fp32 {l32}")
    log(f"  losses: kernel {lk:.6f}, plain {lp:.6f}, fp32 {l32:.6f}; {launched} kernel "
        f"launches (forward + remat recompute); {attn_leaves} attention weights all with "
        f"non-zero gradients; worst leaf {worst['name']}: kernel {worst['kernel_vs_fp32']:.4g} "
        f"and plain {worst['plain_vs_fp32']:.4g} from fp32, kernel vs plain "
        f"{worst['kernel_vs_plain']:.4g} (relative norm; limit {GRAD_FACTOR} x plain + "
        f"{GRAD_FLOOR})")
    return model, dict(loss_kernel=lk, loss_plain=lp, loss_fp32=l32, launches=launched,
                       attention_leaves=attn_leaves, worst_leaf=worst)


def train_quantized_resume(tmp):
    """14c: 8-bit moments, checkpoints every 3 steps, a resume to step 9
    against an uninterrupted run."""
    from repro_torch import configs
    from repro_torch.checkpoint import store
    from repro_torch.launch.train import train
    from repro_torch.optim import AdamW

    cfg = dataclasses.replace(configs.get_config(TRAIN_ARCH), n_periods=2)
    opt = AdamW(peak_lr=3e-4, warmup_steps=2, total_steps=9, quantize_states=True)
    d = os.path.join(tmp, "ckpt")
    kw = dict(global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, opt=opt, device="cuda",
              log_every=100)
    log(f"phase 14c: {cfg.name} at full width cut to {cfg.n_periods} periods, "
        "quantize_states=True: 6 steps checkpointed every 3, a resume to step 9, against "
        "an uninterrupted 9-step run")
    t0 = time.perf_counter()
    first = train(cfg, steps=6, ckpt_dir=d, ckpt_every=3, **kw)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    resumed = train(cfg, steps=3, ckpt_dir=d, ckpt_every=3, **kw)
    t_resumed = time.perf_counter() - t0
    latest = store.latest_step(d)
    ckpt_bytes = sum(os.path.getsize(os.path.join(d, f"step_{latest:08d}", f))
                     for f in os.listdir(os.path.join(d, f"step_{latest:08d}")))
    whole = train(cfg, steps=9, **kw)
    if latest != 9 or resumed["final_step"] != 9:
        raise AssertionError(f"14c: latest step {latest}, final {resumed['final_step']}")
    got, want = np.array(resumed["losses"]), np.array(whole["losses"][6:])
    if not np.allclose(got, want, rtol=RESUME_RTOL, atol=0.0):
        raise AssertionError(f"14c: resumed losses {got} against uninterrupted {want}")
    log(f"  first run {t_first:.2f} s (6 steps, saves at 3 and 6), resume {t_resumed:.2f} s "
        f"(restore + 3 steps + save); checkpoint of step 9 {ckpt_bytes / 1e9:.3f} GB; "
        f"losses 7-9 resumed {got.tolist()} against uninterrupted {want.tolist()} "
        f"(rtol {RESUME_RTOL}); first run {first['losses']}")
    return dict(latest=latest, resumed_losses=got.tolist(), whole_losses=want.tolist(),
                max_rel_diff=float(np.max(np.abs(got - want) / np.abs(want))),
                checkpoint_gb=ckpt_bytes / 1e9, first_s=t_first, resume_s=t_resumed)


def train_chunked_ce(model):
    """14d: one loss and gradient with the chunked CE (``ce_chunk=8192``)
    against the plain CE at full vocabulary, each with its peak memory."""
    import torch

    cfg = model.cfg
    batch = _train_batch(cfg)
    log(f"phase 14d: {cfg.name} ({cfg.n_periods} periods), ce_impl chunked (ce_chunk=8192) "
        f"against plain at vocab {cfg.vocab_size}, {TRAIN_BATCH} x {TRAIN_SEQ} tokens")
    out = {}
    for impl in ("plain", "chunked"):
        c = dataclasses.replace(cfg, ce_impl=impl, ce_chunk=8192)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, grads = _loss_and_grads(model, batch, cfg=c)
        torch.cuda.synchronize()
        out[impl] = dict(loss=loss, seconds=time.perf_counter() - t0,
                         peak_above_start_gb=(torch.cuda.max_memory_allocated() - base) / 1e9,
                         grads=grads)
    gp, gc = out["plain"].pop("grads"), out["chunked"].pop("grads")
    # the chunked CE sums each chunk's bf16 gradient of the hidden state in
    # bf16 (as the reference's scan does), the plain CE's one product
    # accumulates in fp32: reported, not gated
    dist = {k: float(torch.linalg.vector_norm(gc[k].float() - gp[k].float()))
            / (float(torch.linalg.vector_norm(gp[k].float())) + 1e-30) for k in gp}
    worst = max(dist, key=dist.get)
    diff = abs(out["chunked"]["loss"] - out["plain"]["loss"])
    log(f"  loss plain {out['plain']['loss']:.6f}, chunked {out['chunked']['loss']:.6f} "
        f"(|diff| {diff:.3g}, limit {CE_ATOL}); gradients' relative distance: median "
        f"{float(np.median(list(dist.values()))):.4g}, largest {dist[worst]:.4g} "
        f"({worst}); peak memory above the start: plain "
        f"{out['plain']['peak_above_start_gb']:.3f} GB, chunked "
        f"{out['chunked']['peak_above_start_gb']:.3f} GB; seconds plain "
        f"{out['plain']['seconds']:.4f}, chunked {out['chunked']['seconds']:.4f}")
    if diff > CE_ATOL:
        raise AssertionError("14d: the chunked CE's loss is off")
    out["grad_rel_distance"] = dict(largest=dist[worst], leaf=worst,
                                    median=float(np.median(list(dist.values()))))
    return out


def main_path_train(dev):
    import tempfile

    import torch

    t0 = time.perf_counter()
    launches, full = train_full_width(dev)
    model, kvp = train_kernel_vs_plain(dev)
    moments = model_moment_bytes(model)
    ce = train_chunked_ce(model)
    del model
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        resume = train_quantized_resume(tmp)
    resume["moment_bytes"] = moments
    out = dict(full_width=full, kernel_vs_plain=kvp, quantized_resume=resume, chunked_ce=ce,
               seconds=time.perf_counter() - t0)
    log(f"  phase 14: {out['seconds']:.1f} s")
    return out, launches


def model_moment_bytes(model):
    """The optimizer's moments for ``model`` with int8 blocks against fp32."""
    from repro_torch.optim import AdamW

    params = dict(model.named_parameters())
    q = AdamW(quantize_states=True).init(params)
    int8 = sum(t.numel() * t.element_size() for m in (q.mu, q.nu) for pair in m.values()
               for t in pair)
    fp32 = 2 * 4 * sum(p.numel() for p in params.values())
    del q
    log(f"  moments of the {model.cfg.n_periods}-period model: int8 blocks + scales "
        f"{int8 / 1e9:.4f} GB against fp32 {fp32 / 1e9:.4f} GB ({fp32 / int8:.2f}x)")
    return dict(int8=int8, fp32=fp32)


# ---------------------------------------------------------------------------
# Phase 15: MLA/MoE serving and training (DeepSeek-V2-Lite, Kimi-K2's block)
# ---------------------------------------------------------------------------

MLA_ARCH, KIMI_ARCH = "deepseek-v2-lite-16b", "kimi-k2-1t-a32b"
MOE_BATCH, MOE_PROMPT, MOE_GEN, KIMI_GEN = 4, 2048, 32, 8
# 15b: the fp32 witness at full width cut to this many periods (the fp32
# copy of all 27 is 65 GB and does not fit beside the bf16 model)
WITNESS_PERIODS = 4
MOE_STEPS = ("route", "aux_loss", "dispatch_plan", "dispatch", "experts", "combine")
# device-time groups of a profiled MoE-model call: the MoE steps' ranges
MOE_GROUPS = {"router": ("route", "aux_loss"), "dispatch/combine":
              ("dispatch_plan", "dispatch", "combine"), "expert bmm": ("experts",)}


class MoEProbe:
    """A test harness around the MoE block's steps (``repro_torch.models.moe``
    ``route`` ... ``combine``), not a knob of any entry point: while entered,
    it records every ``route`` call's expert ids in ``ids`` or, given
    ``replay`` (another run's ``ids``), replays them in order with this run's
    gates at those ids; ``plans=True`` keeps every dispatch plan; and
    ``ranges=True`` runs each step inside a ``record_function`` range, so a
    profile can group device time by step."""

    def __init__(self, replay=None, plans=False, ranges=False):
        self.ids, self.plans = [], [] if plans else None
        self.replay = None if replay is None else iter(list(replay))
        self.ranges = ranges

    def __enter__(self):
        from repro_torch.models import moe

        self._moe = moe
        self._orig = {name: getattr(moe, name) for name in MOE_STEPS}
        for name, fn in self._orig.items():
            setattr(moe, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            setattr(self._moe, name, fn)

    def _wrap(self, name, fn):
        import torch

        def call(*args):
            scope = (torch.profiler.record_function(f"moe.{name}") if self.ranges
                     else contextlib.nullcontext())
            with scope:
                out = fn(*args)
                if name == "route":
                    if self.replay is not None:
                        probs, _, eidx = out
                        eidx = next(self.replay)
                        out = (probs, self._moe.gates_at(probs, eidx), eidx)
                    self.ids.append(out[2])
                elif name == "dispatch_plan" and self.plans is not None:
                    self.plans.append(out)
            return out

        return call


def profile_moe(tag, fn):
    """``fn`` (after a warm-up call) under ``torch.profiler`` with the MoE
    steps in ranges: wall time, device busy and idle share, and device time
    grouped as the flash kernel, each MoE group and the rest.  The profiler
    and the ranges add host time, so the idle share is also given against
    the wall time of a call with neither (``idle_share_unprofiled``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3
    with MoEProbe(ranges=True):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    avgs = prof.key_averages()
    kernels = [ev for ev in avgs if ev.device_type == DeviceType.CUDA
               and ev.self_device_time_total > 0 and not ev.key.startswith("moe.")]
    busy_ms = sum(ev.self_device_time_total for ev in kernels) / 1e3
    launches = sum(ev.count for ev in kernels)
    ranges = {ev.key[4:]: ev.device_time_total / 1e3 for ev in avgs
              if ev.device_type == DeviceType.CPU and ev.key.startswith("moe.")}
    groups = {"attention kernel": sum(ev.self_device_time_total for ev in kernels
                                      if "flash" in ev.key) / 1e3}
    for group, steps in MOE_GROUPS.items():
        groups[group] = sum(ranges.get(s, 0.0) for s in steps)
    groups["rest"] = busy_ms - sum(groups.values())
    idle = 1 - busy_ms / wall_ms
    idle_plain = 1 - busy_ms / plain_wall_ms
    log(f"  profiled {tag}: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, idle share "
        f"{100 * idle:.1f}% ({100 * idle_plain:.1f}% of an unprofiled call's wall "
        f"{plain_wall_ms:.3f} ms), {launches} kernel launches; device ms by group: "
        + ", ".join(f"{g} {ms:.3f} ({100 * ms / max(busy_ms, 1e-9):.1f}%)"
                    for g, ms in groups.items()))
    top = sorted(kernels, key=lambda ev: -ev.self_device_time_total)[:6]
    for ev in top:
        log(f"    {ev.self_device_time_total / 1e3:9.3f} ms x{ev.count:<5d} {ev.key[:90]}")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, idle_share=idle, launches=launches,
                unprofiled_wall_ms=plain_wall_ms, idle_share_unprofiled=idle_plain,
                groups=groups, step_ranges_ms=ranges)


def _prompts(cfg, dev):
    import torch

    return torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (MOE_BATCH, MOE_PROMPT)), dtype=torch.long, device=dev)


def _flip_shares(ids_a, ids_b):
    """Per layer, the share of tokens whose set of experts differs."""
    import torch

    return [float((torch.sort(a, -1).values != torch.sort(b, -1).values).any(-1)
                  .float().mean()) for a, b in zip(ids_a, ids_b)]


def mla_serve_full(dev, keep=None):
    """15a-15b at full depth: ``serve`` of DeepSeek-V2-Lite, then the same
    weights rebuilt: a repeated prefill's bits, profiles, and the kernel run
    against the plain one with routes pinned (the gap printed) and unpinned
    (the flip share printed).  ``keep`` receives the kernel run's prefill
    logits and routes and the pinned gap, for phase 17b."""
    import torch

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import variant
    from repro_torch.launch.serve import serve
    from repro_torch.models.model import Transformer

    cfg = configs.get_config(MLA_ARCH)
    m = cfg.mla
    n_mla = cfg.n_periods * cfg.period.count("mla")
    d, dv = m.qk_nope_dim + m.qk_rope_dim, m.v_head_dim
    kind = variant(torch.bfloat16, d, dv)
    log(f"phase 15a: serve {cfg.name} at full width and depth ({cfg.n_periods} x (mla, moe), "
        f"d_model {cfg.d_model}, {m.n_heads} heads, kv_lora {m.kv_lora_rank}, d {d} / dv {dv}, "
        f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k} + {cfg.moe.n_shared} shared, "
        f"d_ff {cfg.moe.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}, {_param_count(cfg):,} "
        f"parameters), batch {MOE_BATCH}, prompt {MOE_PROMPT}, {MOE_GEN} generated, seed 0; "
        f"flash variant at ({d}, {dv}): {kind}")
    if kind != "wgmma":
        raise AssertionError(f"15a: MLA's prefill takes the {kind} variant, not wgmma")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = serve(cfg, batch=MOE_BATCH, prompt_len=MOE_PROMPT, gen_tokens=MOE_GEN, seed=0)
    serve_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    gen = out["generated"]
    tokens = MOE_BATCH * MOE_PROMPT
    log(f"  serve: {serve_s:.3f} s in all (init included); prefill {out['prefill_s']:.4f} s "
        f"({tokens / out['prefill_s']:.1f} prompt tokens/s); decode {out['decode_s']:.4f} s "
        f"for {MOE_GEN - 1} steps, {out['tokens_per_s']:.2f} tokens/s; peak memory "
        f"{peak_gb:.2f} GB; kernel launches {launches}")
    if launches["flash_attention"] != n_mla:
        raise AssertionError(f"15a: prefill launched flash_attention "
                             f"{launches['flash_attention']} times, expected {n_mla}")
    if gen.shape != (MOE_BATCH, MOE_GEN) or gen.min() < 0 or gen.max() >= cfg.vocab_size:
        raise AssertionError(f"15a: generated tokens {gen.shape} out of range")

    model = Transformer(cfg, device=dev, seed=0)
    prompts = _prompts(cfg, dev)
    S_max = MOE_PROMPT + MOE_GEN
    pos = torch.full((MOE_BATCH,), MOE_PROMPT, dtype=torch.long, device=dev)
    with torch.inference_mode():
        with MoEProbe(plans=True) as kernel_run:
            lk, ck = model.prefill(prompts, S_max)
            tok = lk[:, -1].argmax(-1)
            dk, _ = model.decode_step(ck, tok, pos)
        n_moe = cfg.n_periods * cfg.period.count("moe")
        dropped = [1 - float(p.keep.float().mean()) for p in kernel_run.plans[:n_moe]]
        C = kernel_run.plans[0].src.numel() // cfg.moe.num_experts
        log(f"  prefill's dropped pairs by layer (C = {C}): {[round(x, 4) for x in dropped]}")
        if tok.tolist() != gen[:, 0].tolist():
            raise AssertionError(f"15a: rebuilt weights give first tokens {tok.tolist()}, "
                                 f"serve gave {gen[:, 0].tolist()}")
        l2, c2 = model.prefill(prompts, S_max)
        same = torch.equal(l2, lk) and all(
            torch.equal(a.c_kv[:, :MOE_PROMPT], b.c_kv[:, :MOE_PROMPT])
            and torch.equal(a.k_pe[:, :MOE_PROMPT], b.k_pe[:, :MOE_PROMPT])
            for a, b in zip(c2, ck) if a is not None)
        del c2, l2
        log(f"  a second prefill gives the same bits (logits and every latent cache): {same}")
        if not same:
            raise AssertionError("15a: two prefills of the same prompts differ")
        prof = {"prefill": profile_moe("prefill", lambda: model.prefill(prompts, S_max)),
                "decode": profile_moe("decode step", lambda: model.decode_step(ck, tok, pos))}
        del ck
        with MoEProbe(replay=kernel_run.ids):
            lp, cp = model.prefill(prompts, S_max, use_kernel=False)
            dp, _ = model.decode_step(cp, tok, pos)
        del cp
        with MoEProbe() as plain_run:
            model.prefill(prompts, S_max, use_kernel=False)
    flips = _flip_shares(kernel_run.ids[:n_moe], plain_run.ids)
    gap = dict(prefill=float((lk[:, -1].float() - lp[:, -1].float()).abs().max()),
               decode=float((dk[:, 0].float() - dp[:, 0].float()).abs().max()))
    for tag, t in (("prefill last-token", lk), ("teacher-forced decode", dk)):
        if t.shape[-1] != cfg.vocab_size or not bool(torch.isfinite(t).all()):
            raise AssertionError(f"15a: {tag} logits not finite of width {cfg.vocab_size}")
    log(f"  15b at full depth, routes pinned to the kernel run: max |logit| gap kernel vs "
        f"plain, prefill {gap['prefill']:.6g}, decode {gap['decode']:.6g} (not gated); "
        f"unpinned, the plain run's share of tokens routed to another expert set, by layer: "
        f"{[round(f, 4) for f in flips]} (mean {float(np.mean(flips)):.4f}; not gated)")
    if keep is not None:
        keep.update(flash=lk[:, -1].float().cpu(), routes=[i.cpu() for i in kernel_run.ids[:n_moe]],
                    plain_gap=gap["prefill"], prefill_s=out["prefill_s"])
    del model
    torch.cuda.empty_cache()
    return launches, dict(prefill_s=out["prefill_s"], prompt_tokens_per_s=tokens / out["prefill_s"],
                          decode_s=out["decode_s"], tokens_per_s=out["tokens_per_s"],
                          serve_s=serve_s, peak_memory_gb=peak_gb, variant=kind,
                          dropped_pair_share=dropped,
                          profile=prof, pinned_gap=gap, unpinned_flip_share=flips)


def mla_witness(dev):
    """15b at full width cut to WITNESS_PERIODS periods: the kernel model
    against the plain-attention model and an fp32 copy, routes pinned to the
    kernel run's, by phase 6's ``LM_FACTOR`` rule."""
    import torch

    from repro_torch import configs
    from repro_torch.models.model import Transformer

    cfg = dataclasses.replace(configs.get_config(MLA_ARCH), n_periods=WITNESS_PERIODS)
    log(f"phase 15b: {cfg.name} at full width cut to {cfg.n_periods} periods (the fp32 copy "
        f"of all 27 is 65 GB), batch {MOE_BATCH} x {MOE_PROMPT}: kernel against "
        "use_kernel=False and an fp32 copy, routes pinned to the kernel run's")
    model = Transformer(cfg, device=dev, seed=0)
    model32 = Transformer.from_params(dataclasses.replace(cfg, dtype="float32"),
                                      model.state_dict(), device=dev)
    prompts = _prompts(cfg, dev)
    S_max = MOE_PROMPT + MOE_GEN
    pos = torch.full((MOE_BATCH,), MOE_PROMPT, dtype=torch.long, device=dev)
    runs = {}
    with torch.inference_mode():
        with MoEProbe() as kernel_run:
            lk, ck = model.prefill(prompts, S_max)
            tok = lk[:, -1].argmax(-1)
            runs["kernel"] = (lk, model.decode_step(ck, tok, pos)[0])
        del ck
        for name, mdl in (("plain", model), ("fp32", model32)):
            with MoEProbe(replay=kernel_run.ids):
                lo, c = mdl.prefill(prompts, S_max, use_kernel=False)
                runs[name] = (lo, mdl.decode_step(c, tok, pos)[0])
            del c
        with MoEProbe() as plain_run:
            model.prefill(prompts, S_max, use_kernel=False)
    del model, model32
    torch.cuda.empty_cache()
    (lk, dk), (lp, dp), (l32, d32) = runs["kernel"], runs["plain"], runs["fp32"]
    pre = _logit_dists(lk[:, -1], lp[:, -1], l32[:, -1])
    dec = _logit_dists(dk[:, 0], dp[:, 0], d32[:, 0])
    for tag, dists in (("15b prefill last-token logits", pre),
                       ("15b teacher-forced decode logits", dec)):
        judge_logits(tag, dists)
    flips = _flip_shares(kernel_run.ids[:cfg.n_periods], plain_run.ids)
    log(f"  unpinned flip share by layer: {[round(f, 4) for f in flips]}")
    return dict(periods=cfg.n_periods, prefill_logits=pre, decode_logits=dec,
                unpinned_flip_share=flips)


def kimi_period(dev):
    """15c: Kimi-K2 at full width, one period of 61, through ``serve``; then
    the same weights rebuilt, outside the timed call: serve's greedy steps
    again under a probe (the same tokens, finite logits, unique slots, the
    dropped share), and the prefill's last-token logits and one
    teacher-forced decode step against ``use_kernel=False`` with routes
    pinned to the kernel run's (the gap printed)."""
    import torch

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import variant
    from repro_torch.launch.serve import serve
    from repro_torch.models.model import Transformer
    from repro_torch.models.moe import capacity as moe_capacity
    from repro_torch.models.moe import expert_counts as moe_counts

    full = configs.get_config(KIMI_ARCH)
    cfg = dataclasses.replace(full, n_periods=1)
    n_params = _param_count(cfg)
    kind = variant(torch.bfloat16, cfg.d_head, cfg.d_head)
    log(f"phase 15c: serve {cfg.name} at full width (d_model {cfg.d_model}, {cfg.n_heads}/"
        f"{cfg.n_kv_heads} heads of {cfg.d_head}, {cfg.moe.num_experts} experts top-"
        f"{cfg.moe.top_k} + {cfg.moe.n_shared} shared, d_ff {cfg.moe.d_ff}, vocab "
        f"{cfg.vocab_size}), cut to 1 period of {full.n_periods} ({n_params:,} parameters, "
        f"{2 * n_params / 1e9:.1f} GB in bf16: all {full.n_periods} are "
        f"{_param_count(full) / 1e12:.2f} T parameters and do not fit one card), batch "
        f"{MOE_BATCH}, prompt {MOE_PROMPT}, {KIMI_GEN} generated; flash variant at "
        f"({cfg.d_head}, {cfg.d_head}), group {cfg.n_heads // cfg.n_kv_heads}: {kind}")
    if kind != "wgmma":
        raise AssertionError(f"15c: GQA prefill takes the {kind} variant, not wgmma")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = serve(cfg, batch=MOE_BATCH, prompt_len=MOE_PROMPT, gen_tokens=KIMI_GEN, seed=0)
    launches = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    gen = out["generated"]
    log(f"  serve: prefill {out['prefill_s']:.4f} s ({MOE_BATCH * MOE_PROMPT / out['prefill_s']:.1f} "
        f"prompt tokens/s); decode {out['decode_s']:.4f} s for {KIMI_GEN - 1} steps, "
        f"{out['tokens_per_s']:.2f} tokens/s; peak memory {peak_gb:.2f} GB; kernel launches "
        f"{launches}")
    if launches["flash_attention"] != 1:
        raise AssertionError(f"15c: {launches['flash_attention']} flash launches, expected 1")

    torch.cuda.empty_cache()
    model = Transformer(cfg, device=dev, seed=0)
    prompts = _prompts(cfg, dev)
    S_max = MOE_PROMPT + KIMI_GEN
    pos0 = torch.full((MOE_BATCH,), MOE_PROMPT, dtype=torch.long, device=dev)
    with torch.inference_mode():
        with MoEProbe(plans=True) as kernel_run:
            lk, cache = model.prefill(prompts, S_max)
            logits = [lk[:, -1]]
            for i in range(KIMI_GEN - 1):
                tok = logits[-1].argmax(-1)
                pos = torch.full((MOE_BATCH,), MOE_PROMPT + i, dtype=torch.long, device=dev)
                logits.append(model.decode_step(cache, tok, pos)[0][:, 0])
        del cache
        tok0 = logits[0].argmax(-1)
        with MoEProbe(replay=kernel_run.ids):
            lp, cp = model.prefill(prompts, S_max, use_kernel=False)
            dp, _ = model.decode_step(cp, tok0, pos0)
        del cp
    del model
    torch.cuda.empty_cache()
    tokens = torch.stack([lo.argmax(-1) for lo in logits], 1).cpu().numpy()
    finite = all(lo.shape[-1] == cfg.vocab_size and bool(torch.isfinite(lo).all())
                 for lo in logits)
    if not finite:
        raise AssertionError("15c: logits not finite")
    if not np.array_equal(tokens, gen):
        raise AssertionError(f"15c: rebuilt weights give tokens {tokens.tolist()}, serve gave "
                             f"{gen.tolist()}")
    for plan in kernel_run.plans:
        kept = plan.slot[plan.keep]
        if kept.unique().numel() != kept.numel():
            raise AssertionError("15c: two kept pairs share a slot")
    prefill_plan = kernel_run.plans[0]
    dropped = 1 - float(prefill_plan.keep.float().mean())
    load = moe_counts(kernel_run.ids[0], cfg.moe.num_experts).float()
    load_ratio = float(load.max() / load.mean())
    dropped_decode = [1 - float(p.keep.float().mean()) for p in kernel_run.plans[1:]]
    C = moe_capacity(MOE_BATCH * MOE_PROMPT, cfg.moe)
    gap = dict(prefill=float((logits[0].float() - lp[:, -1].float()).abs().max()),
               decode=float((logits[1].float() - dp[:, 0].float()).abs().max()),
               logit_std=float(logits[0].float().std()))
    log(f"  rebuilt weights, outside the timed call: serve's {KIMI_GEN} tokens again, "
        f"{KIMI_GEN} logits calls all finite; prefill capacity C = {C}, dropped pairs "
        f"{100 * dropped:.3f}% of {prefill_plan.keep.numel()} (the busiest expert's load "
        f"{load_ratio:.2f}x the mean); decode steps' dropped share at most "
        f"{max(dropped_decode):.4f}; routes pinned to the kernel run: max |logit| gap kernel "
        f"vs plain, prefill {gap['prefill']:.6g}, decode {gap['decode']:.6g} (logit std "
        f"{gap['logit_std']:.6g}; not gated: no fp32 copy fits beside the bf16 period, and "
        "phase 5 holds the kernel at this shape against fp32)")
    return launches, dict(prefill_s=out["prefill_s"], decode_s=out["decode_s"],
                          tokens_per_s=out["tokens_per_s"], peak_memory_gb=peak_gb,
                          dropped_pair_share=dropped, busiest_expert_load=load_ratio,
                          capacity=C, params=n_params, pinned_gap=gap)


def mla_train(dev):
    """15d: three ``make_train_step`` steps of DeepSeek-V2-Lite at full width
    and 2 periods on one fixed batch, remat full."""
    import torch

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models.model import Transformer, make_train_step
    from repro_torch.optim import AdamW

    cfg = dataclasses.replace(configs.get_config(MLA_ARCH), n_periods=2)
    n_mla = cfg.n_periods * cfg.period.count("mla")
    log(f"phase 15d: three make_train_step steps of {cfg.name} at full width cut to "
        f"{cfg.n_periods} periods ({_param_count(cfg):,} parameters), one batch of "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens, remat {cfg.remat_policy}, AdamW(peak_lr=3e-4, "
        "warmup_steps=1) with fp32 moments")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = Transformer(cfg, device=dev, seed=0)
    opt = AdamW(peak_lr=3e-4, warmup_steps=1, total_steps=10)
    state = opt.init(dict(model.named_parameters()))
    step = make_train_step(opt)
    batch = _train_batch(cfg)
    ops.reset_launch_counts()
    losses, seconds = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        loss, state = step(model, state, batch)
        losses.append(float(loss))
        seconds.append(time.perf_counter() - t0)
    launches = ops.launch_counts()
    with torch.no_grad():
        _, aux = model.hidden(batch["tokens"][:, :-1])
    aux = float(aux)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expected = 2 * n_mla * 3
    log(f"  losses {losses} (CE + aux); aux after the steps {aux:.6g}; step seconds "
        f"{[round(s, 4) for s in seconds]}; peak memory {peak_gb:.2f} GB; kernel launches "
        f"{launches} (expected {expected}: forward and remat recompute a layer a step)")
    if not (np.isfinite(losses).all() and losses[2] < losses[0]):
        raise AssertionError(f"15d: losses {losses} not finite and falling")
    if not aux > 0:
        raise AssertionError(f"15d: aux loss {aux}")
    if launches["flash_attention"] != expected:
        raise AssertionError(f"15d: {launches['flash_attention']} flash launches, "
                             f"expected {expected}")
    del model, state
    torch.cuda.empty_cache()
    return launches, dict(losses=losses, aux=aux, step_seconds=seconds, peak_memory_gb=peak_gb,
                          periods=cfg.n_periods)


def main_path_moe(dev, keep=None):
    t0 = time.perf_counter()
    serve_launches, full = mla_serve_full(dev, keep)
    witness = mla_witness(dev)
    kimi_launches, kimi = kimi_period(dev)
    train_launches, train = mla_train(dev)
    out = dict(deepseek=full, witness=witness, kimi=kimi, train=train,
               seconds=time.perf_counter() - t0)
    log(f"  phase 15: {out['seconds']:.1f} s")
    return out, dict(mla_serve=serve_launches, kimi=kimi_launches, mla_train=train_launches)


# ---------------------------------------------------------------------------
# Phase 16: the SSM, hybrid, VLM and audio families
# ---------------------------------------------------------------------------

SSM_ARCH, JAMBA_ARCH, VLM_ARCH, AUDIO_ARCH = ("xlstm-1.3b", "jamba-1.5-large-398b",
                                              "qwen2-vl-2b", "hubert-xlarge")
SSM_BATCH, SSM_PROMPT, SSM_GEN, JAMBA_GEN = 4, 2048, 32, 8
# 16b: the first 5 layers of Jamba-1.5-Large's 8-layer period at full width,
# sub-blocks period[:10]: 4 Mamba, 1 attention, 3 dense MLP, 2 MoE (one
# period is ~44 B parameters, 88 GB in bf16, and does not fit one card)
JAMBA_SUBBLOCKS = 10
# 16b's LM_FACTOR witness: period positions 2-3 and 8-9, a Mamba + MoE layer
# and the attention + MLP layer (every block type that differs between the
# kernel and the plain run, and the MoE whose routes are pinned), 11.9 B
# parameters: its fp32 copy (47.6 GB) does not fit beside 16b's bf16 cut, so
# the bf16 model runs first, then its weights go to the host and come back
# as the fp32 copy
JAMBA_WITNESS = (2, 3, 8, 9)
# 16d: 30 s clips at 50 frames/s; training at full width cut to 4 periods
AUDIO_FRAMES, AUDIO_TRAIN_PERIODS = 1500, 4
# 16a: the card's fp32 logits against the CPU port's, xLSTM at full width
# cut to 1 period, B = 1 x 256 tokens.  The same fp32 products summed in
# another order on each device: a dot product of K terms moves by ~sqrt(K)
# 2^-24 of its terms' magnitude (K <= 4,096 here: ~4e-6); the 8 residual
# blocks and the head add such errors up to ~1e-5 of the logits' scale.
# The bound is 100 times that: max |card - cpu| <= CARD_CPU_TOL * max |cpu|.
CARD_CPU_TOL = 1e-3
# 16a: token-by-token decode from init_cache against forward on the card in
# fp32, tests/test_models.py::test_ssm_decode_matches_forward_stepwise's
# tolerance (atol = rtol = 2e-2)
STEPWISE_TOL = 2e-2


def profile_cuda(tag, fn):
    """Device busy time and kernel launches of one call of ``fn`` under
    ``torch.profiler`` with CUDA activity only (a call of ~10^5 launches
    would take long to trace with every CPU op), and the host seconds that
    tracing took."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3
    rows = [ev for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0]
    busy_ms = sum(ev.self_device_time_total for ev in rows) / 1e3
    launches = sum(ev.count for ev in rows)
    trace_s = time.perf_counter() - t0
    log(f"  profiled {tag} (CUDA activity only): wall {wall_ms:.3f} ms, device busy "
        f"{busy_ms:.3f} ms, {launches} kernel launches; tracing took {trace_s:.1f} s")
    for ev in sorted(rows, key=lambda ev: -ev.self_device_time_total)[:5]:
        log(f"    {ev.self_device_time_total / 1e3:9.3f} ms x{ev.count:<7d} {ev.key[:80]}")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, launches=launches)


def block_ms(model, x):
    """Milliseconds of each sub-block's forward over ``x`` (the prompt's
    embeddings), CUDA events between the blocks, which run back to back: in a
    device-bound prefill the device is busy throughout, so each interval is
    its block's device time."""
    import torch

    positions = model._positions(x.shape[0], x.shape[1], x.device)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(len(model.blocks) + 1)]
    events[0].record()
    for blk, ev in zip(model.blocks, events[1:]):
        x = blk(x, positions)[0]
        ev.record()
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in zip(events, events[1:])]


def _ssm_prompts(cfg, dev, batch=SSM_BATCH, prompt=SSM_PROMPT):
    """``serve``'s prompts: the first draw of ``default_rng(0)``."""
    import torch

    return torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, prompt)), dtype=torch.long, device=dev)


def _serve_and_rebuild(tag, cfg, dev, gen_tokens, probe=False):
    """``serve`` on the card, then the same weights rebuilt from seed 0
    outside the timed call: serve's greedy tokens again from a prefill and
    decode steps (under a ``MoEProbe`` keeping dispatch plans with
    ``probe``), every logits call finite, a second prefill's bits.  Returns
    (launches of the serve, serve's report, the rebuilt model, prompts,
    the first prefill's logits and cache, the probe, the second prefill's
    host seconds)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.models.model import Transformer

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = serve(cfg, batch=SSM_BATCH, prompt_len=SSM_PROMPT, gen_tokens=gen_tokens, seed=0)
    serve_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["serve_s"] = serve_s
    gen = out["generated"]
    tokens = SSM_BATCH * SSM_PROMPT
    log(f"  serve: {serve_s:.3f} s in all (init included); prefill {out['prefill_s']:.4f} s "
        f"({tokens / out['prefill_s']:.1f} prompt tokens/s); decode {out['decode_s']:.4f} s "
        f"for {gen_tokens - 1} steps, {out['tokens_per_s']:.2f} tokens/s; peak memory "
        f"{out['peak_memory_gb']:.2f} GB; kernel launches {launches}")
    if gen.shape != (SSM_BATCH, gen_tokens) or gen.min() < 0 or gen.max() >= cfg.vocab_size:
        raise AssertionError(f"{tag}: generated tokens {gen.shape} out of range")
    torch.cuda.empty_cache()
    model = Transformer(cfg, device=dev, seed=0)
    prompts = _ssm_prompts(cfg, dev)
    S_max = SSM_PROMPT + gen_tokens
    scope = MoEProbe(plans=True) if probe else contextlib.nullcontext()
    with torch.inference_mode():
        with scope as run:
            lk, cache = model.prefill(prompts, S_max)
            logits = [lk[:, -1]]
            for i in range(gen_tokens - 1):
                pos = torch.full((SSM_BATCH,), SSM_PROMPT + i, dtype=torch.long, device=dev)
                logits.append(model.decode_step(cache, logits[-1].argmax(-1), pos)[0][:, 0])
        tokens_again = torch.stack([lo.argmax(-1) for lo in logits], 1).cpu().numpy()
        finite = all(lo.shape[-1] == cfg.vocab_size and bool(torch.isfinite(lo).all())
                     for lo in logits)
        del cache
        (l2, c2), second_s = timed(lambda: model.prefill(prompts, S_max))
        same = torch.equal(l2, lk)
        del l2, c2
    again = np.array_equal(tokens_again, gen)
    log(f"  rebuilt weights: serve's {gen_tokens} tokens again {again}, "
        f"every logits call finite {finite}; a second prefill ({second_s:.4f} s, unprofiled) "
        f"gives the same bits: {same}")
    if not finite:
        raise AssertionError(f"{tag}: logits not finite")
    if not again:
        raise AssertionError(f"{tag}: rebuilt weights give tokens {tokens_again.tolist()}, "
                             f"serve gave {gen.tolist()}")
    if not same:
        raise AssertionError(f"{tag}: two prefills of the same prompts differ")
    return launches, out, model, prompts, lk, run, second_s


def xlstm_serve(dev):
    """16a: xLSTM-1.3B at full width and depth through ``serve``; where its
    time goes; the card against the CPU port at 1 period; decode token by
    token against forward on the card."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.models.model import Transformer

    cfg = configs.get_config(SSM_ARCH)
    n_params = _param_count(cfg)
    m, sl = cfg.mlstm, cfg.slstm
    log(f"phase 16a: serve {cfg.name} at full width and depth ({cfg.n_periods} x "
        f"({cfg.period.count('mlstm')} mLSTM + {cfg.period.count('slstm')} sLSTM), d_model "
        f"{cfg.d_model}, mLSTM d_inner {m.d_inner} in {m.n_heads} heads of "
        f"{m.d_inner // m.n_heads}, sLSTM {sl.n_heads} heads, vocab {cfg.vocab_size}, "
        f"{cfg.dtype}, ssm_chunk {cfg.ssm_chunk}; {n_params:,} parameters, where the name "
        f"says 1.3 B), batch {SSM_BATCH}, prompt {SSM_PROMPT}, {SSM_GEN} generated, seed 0")
    launches, out, model, prompts, lk, _, second_s = _serve_and_rebuild("16a", cfg, dev, SSM_GEN)
    S_max = SSM_PROMPT + SSM_GEN
    with torch.inference_mode():
        # one layer of each kind on the prompt's embeddings, timed before any
        # profile (a profiler session can leave the host's launches slower)
        x = model.embed[prompts]
        mlstm, slstm = model.blocks[0], model.blocks[cfg.period.index("slstm")]
        for _ in range(2):  # the second of each
            _, mlstm_s = timed(lambda: mlstm(x))
            _, slstm_s = timed(lambda: slstm(x))
        # a decode step, and the prefill of one period (tracing all 6, ~343 k
        # launches, takes over a minute): the sLSTM loop's launches a step
        cache = model.init_cache(SSM_BATCH, S_max)  # what the prefill returns (a fresh state)
        tok = lk[:, -1].argmax(-1)
        pos = torch.full((SSM_BATCH,), SSM_PROMPT, dtype=torch.long, device=dev)
        dec = profile_cuda("decode step", lambda: model.decode_step(cache, tok, pos))
        P = len(cfg.period)
        period = torch.nn.Sequential(*model.blocks[:P])

        def one_period():
            h = x
            for blk in period:
                h = blk(h)[0]
            return h

        pre = profile_cuda(f"prefill of one period ({P} layers)", one_period)
        del cache
    step_ms = out["decode_s"] / (SSM_GEN - 1) * 1e3
    n_m, n_s = cfg.n_periods * cfg.period.count("mlstm"), cfg.n_periods * cfg.period.count("slstm")
    idle = dict(prefill_period=1 - pre["busy_ms"] / pre["wall_ms"],
                decode=1 - dec["busy_ms"] / step_ms)
    log(f"  an unprofiled prefill {second_s:.4f} s; one period's layers, profiled: wall "
        f"{pre['wall_ms']:.1f} ms, busy {pre['busy_ms']:.1f} ms (idle "
        f"{100 * idle['prefill_period']:.1f}%), {pre['launches']} launches (x "
        f"{cfg.n_periods} periods: ~{cfg.n_periods * pre['launches']} a prefill, "
        f"~{pre['launches'] / SSM_PROMPT:.1f} a prompt step); a decode step {step_ms:.3f} ms "
        f"(serve's mean), busy {dec['busy_ms']:.3f} ms: idle {100 * idle['decode']:.1f}%, "
        f"{dec['launches']} launches; unprofiled, one mLSTM layer {mlstm_s:.4f} s (x {n_m}) "
        f"and one sLSTM layer {slstm_s:.4f} s (x {n_s}) on {SSM_BATCH} x {SSM_PROMPT}")
    del model, x, period
    torch.cuda.empty_cache()

    # the card against the CPU, and decode against forward, at 1 period in fp32
    cut = dataclasses.replace(cfg, n_periods=1, dtype="float32")
    log(f"  16a at full width cut to 1 period ({_param_count(cut):,} parameters), fp32, "
        "B = 1 x 256: the card against the CPU port (same weights), then token-by-token "
        "decode from init_cache against forward on the card")
    t0 = time.perf_counter()
    cpu_model = Transformer(cut, device="cpu", seed=0)
    card_model = Transformer.from_params(cut, cpu_model.state_dict(), device=dev)
    toks = torch.as_tensor(np.random.default_rng(1).integers(0, cut.vocab_size, (1, 256)))
    with torch.inference_mode():
        want, _ = cpu_model(toks)
        got, _ = card_model(toks.to(dev))
        cache = card_model.init_cache(1, 256)
        steps = torch.stack([card_model.decode_step(
            cache, toks[:, t].to(dev), torch.tensor([t], device=dev))[0][:, 0]
            for t in range(256)], 1)
    del cpu_model, card_model, cache
    got = got.cpu()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    step_err = float((steps.cpu() - got).abs().max())
    step_ok = bool(torch.all((steps.cpu() - got).abs() <= STEPWISE_TOL * (1 + got.abs())))
    log(f"  card vs CPU: max |logit| difference {err:.6g} against max |logit| {scale:.6g} "
        f"(bound {CARD_CPU_TOL} x that = {CARD_CPU_TOL * scale:.6g}); stepwise decode vs "
        f"forward on the card: max difference {step_err:.6g} (tolerance {STEPWISE_TOL} + "
        f"{STEPWISE_TOL} x |forward|: {step_ok}); {time.perf_counter() - t0:.1f} s")
    if not bool(torch.isfinite(got).all()) or err > CARD_CPU_TOL * scale:
        raise AssertionError("16a: the card's logits disagree with the CPU port's")
    if not step_ok:
        raise AssertionError("16a: token-by-token decode disagrees with forward")
    torch.cuda.empty_cache()
    return launches, dict(params=n_params, prefill_s=out["prefill_s"],
                          decode_s=out["decode_s"], tokens_per_s=out["tokens_per_s"],
                          serve_s=out["serve_s"], peak_memory_gb=out["peak_memory_gb"],
                          second_prefill_s=second_s, period_prefill_profile=pre,
                          decode_profile=dec, idle_share=idle,
                          mlstm_layer_s=mlstm_s, slstm_layer_s=slstm_s,
                          card_vs_cpu=dict(max_abs=err, logit_max=scale),
                          stepwise_max_abs=step_err)


def jamba_block(dev):
    """16b: Jamba-1.5-Large's period cut to its first 5 layers, at full width,
    through ``serve``; unique MoE slots, the Mamba layers' share of prefill
    device time; the LM_FACTOR witness at a further cut."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.kernels.flash_attention import variant

    full = configs.get_config(JAMBA_ARCH)
    cfg = dataclasses.replace(full, n_periods=1, period=full.period[:JAMBA_SUBBLOCKS])
    n_params = _param_count(cfg)
    kind = variant(torch.bfloat16, cfg.d_head, cfg.d_head)
    log(f"phase 16b: serve {cfg.name} at full width (d_model {cfg.d_model}, GQA "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.d_head}, Mamba d_inner "
        f"{cfg.mamba.d_inner} d_state {cfg.mamba.d_state}, {cfg.moe.num_experts} experts "
        f"top-{cfg.moe.top_k} of d_ff {cfg.moe.d_ff}, dense d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}), cut to the first {JAMBA_SUBBLOCKS // 2} layers of its 8-layer "
        f"period {cfg.period} ({n_params:,} parameters, {2 * n_params / 1e9:.1f} GB in bf16; "
        f"the {full.n_periods} periods are {_param_count(full) / 1e9:.1f} B), batch "
        f"{SSM_BATCH}, prompt {SSM_PROMPT}, {JAMBA_GEN} generated; flash variant at "
        f"({cfg.d_head}, {cfg.d_head}), group {cfg.n_heads // cfg.n_kv_heads}: {kind}")
    if kind != "wgmma":
        raise AssertionError(f"16b: GQA prefill takes the {kind} variant, not wgmma")
    launches, out, model, prompts, lk, run, second_s = _serve_and_rebuild(
        "16b", cfg, dev, JAMBA_GEN, probe=True)
    if launches["flash_attention"] != 1:
        raise AssertionError(f"16b: {launches['flash_attention']} flash launches, expected 1")
    for plan in run.plans:
        kept = plan.slot[plan.keep]
        if kept.unique().numel() != kept.numel():
            raise AssertionError("16b: two kept pairs share a slot")
    n_moe = cfg.period.count("moe")
    dropped = [1 - float(p.keep.float().mean()) for p in run.plans[:n_moe]]
    S_max = SSM_PROMPT + JAMBA_GEN
    with torch.inference_mode():
        x = model.embed[prompts]
        block_ms(model, x)
        ms = block_ms(model, x)
        prof = profile_device("prefill", lambda: model.prefill(prompts, S_max))
    by_type = {b: sum(t for t, bt in zip(ms, cfg.period) if bt == b)
               for b in dict.fromkeys(cfg.period)}
    mamba_share = by_type["mamba"] / sum(ms)
    log(f"  prefill: {second_s:.4f} s unprofiled, busy {prof['busy_ms']:.1f} ms (idle "
        f"{100 * (1 - prof['busy_ms'] / (second_s * 1e3)):.1f}% of the unprofiled wall); "
        f"the blocks' forwards back to back, ms by layer {[round(t, 2) for t in ms]}, by "
        f"type {({b: round(t, 2) for b, t in by_type.items()})}: the Mamba layers "
        f"{100 * mamba_share:.1f}%; dropped pairs by MoE layer {[round(x, 4) for x in dropped]}")
    del model, lk, x
    torch.cuda.empty_cache()
    witness = jamba_witness(dev, full)
    return launches, dict(params=n_params, prefill_s=out["prefill_s"],
                          decode_s=out["decode_s"], tokens_per_s=out["tokens_per_s"],
                          serve_s=out["serve_s"], peak_memory_gb=out["peak_memory_gb"],
                          second_prefill_s=second_s, prefill_profile=prof,
                          block_ms=ms, mamba_share=mamba_share, dropped_pair_share=dropped,
                          witness=witness)


def jamba_witness(dev, full):
    """16b's LM_FACTOR rule at the JAMBA_WITNESS cut: the kernel model against
    ``use_kernel=False`` and an fp32 copy of the same weights, routes pinned
    to the kernel run's; prefill last-token logits and a teacher-forced
    decode step."""
    import dataclasses

    import torch

    from repro_torch.models.model import Transformer

    cfg = dataclasses.replace(full, n_periods=1,
                              period=tuple(full.period[i] for i in JAMBA_WITNESS))
    log(f"phase 16b witness: {cfg.name} at full width cut to {cfg.period} "
        f"({_param_count(cfg):,} parameters), batch {SSM_BATCH} x {SSM_PROMPT}: kernel "
        "against use_kernel=False and an fp32 copy (built from the bf16 weights after the "
        "bf16 runs, through the host), routes pinned to the kernel run's")
    t0 = time.perf_counter()
    model = Transformer(cfg, device=dev, seed=0)
    prompts = _ssm_prompts(cfg, dev)
    S_max = SSM_PROMPT + JAMBA_GEN
    pos = torch.full((SSM_BATCH,), SSM_PROMPT, dtype=torch.long, device=dev)
    runs = {}
    with torch.inference_mode():
        with MoEProbe() as kernel_run:
            lk, ck = model.prefill(prompts, S_max)
            tok = lk[:, -1].argmax(-1)
            runs["kernel"] = (lk[:, -1], model.decode_step(ck, tok, pos)[0][:, 0])
        del ck
        with MoEProbe(replay=kernel_run.ids):
            lp, cp = model.prefill(prompts, S_max, use_kernel=False)
            runs["plain"] = (lp[:, -1], model.decode_step(cp, tok, pos)[0][:, 0])
        del cp, lk, lp
    host = {k: v.to("cpu") for k, v in model.state_dict().items()}
    del model
    torch.cuda.empty_cache()
    model32 = Transformer(dataclasses.replace(cfg, dtype="float32"), device=dev, seed=None)
    with torch.no_grad():
        for name, p in model32.state_dict(keep_vars=True).items():
            p.copy_(host.pop(name).to(dev))
    with torch.inference_mode():
        with MoEProbe(replay=kernel_run.ids):
            l32, c32 = model32.prefill(prompts, S_max, use_kernel=False)
            runs["fp32"] = (l32[:, -1], model32.decode_step(c32, tok, pos)[0][:, 0])
        del c32, l32
    del model32
    torch.cuda.empty_cache()
    pre = _logit_dists(*(runs[k][0] for k in ("kernel", "plain", "fp32")))
    dec = _logit_dists(*(runs[k][1] for k in ("kernel", "plain", "fp32")))
    for tag, dists in (("16b prefill last-token logits", pre),
                       ("16b teacher-forced decode logits", dec)):
        judge_logits(tag, dists)
    log(f"  16b witness: {time.perf_counter() - t0:.1f} s")
    return dict(period=cfg.period, prefill_logits=pre, decode_logits=dec)


def hubert_encoder(dev):
    """16d: HuBERT-XLarge's encoder at full width and depth on 4 x 1,500
    frames (the flash kernel's wgmma variant at d = 80, non-causal), held
    by the LM_FACTOR rule; three train steps at 4 periods."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.data import lm as lm_data
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import variant
    from repro_torch.models.model import Transformer, make_train_step
    from repro_torch.optim import AdamW

    cfg = configs.get_config(AUDIO_ARCH)
    n_attn = cfg.n_periods * cfg.period.count("attn")
    kind = variant(torch.bfloat16, cfg.d_head, cfg.d_head)
    log(f"phase 16d: {cfg.name}'s encoder at full width and depth ({cfg.n_periods} x (attn, "
        f"mlp), d_model {cfg.d_model}, {cfg.n_heads} heads of {cfg.d_head}, causal "
        f"{cfg.causal}, d_ff {cfg.d_ff}, {cfg.vocab_size} labels, {cfg.dtype}, "
        f"{_param_count(cfg):,} parameters), frames {SSM_BATCH} x {AUDIO_FRAMES} x "
        f"{cfg.d_model} from frame_embeddings(seed=0); flash variant at d = {cfg.d_head}: "
        f"{kind}")
    if kind != "wgmma":
        raise AssertionError(f"16d: d = {cfg.d_head} takes the {kind} variant, not wgmma")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = Transformer(cfg, device=dev, seed=0)
    frames = lm_data.frame_embeddings(cfg.d_model, AUDIO_FRAMES, SSM_BATCH, seed=0, device=dev)
    with torch.inference_mode():
        ops.reset_launch_counts()
        (lk, _), first_s = timed(lambda: model(frames))
        launches = ops.launch_counts()
        (l2, _), fwd_s = timed(lambda: model(frames))
        same = torch.equal(l2, lk)
        del l2
        prof = profile_device("encoder forward", lambda: model(frames), watch=("flash",))
        lp, _ = model(frames, use_kernel=False)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    flash_ms = sum(r["ms"] for r in prof["top"] if "flash" in r["name"])
    log(f"  forward {first_s:.4f} s (first), {fwd_s:.4f} s (second, the same bits: {same}); "
        f"flash launches {launches['flash_attention']} (expected {n_attn}); the kernel "
        f"{flash_ms:.3f} ms of {prof['busy_ms']:.3f} ms busy "
        f"({100 * flash_ms / max(prof['busy_ms'], 1e-9):.1f}%); peak memory {peak_gb:.2f} GB")
    if launches["flash_attention"] != n_attn:
        raise AssertionError(f"16d: {launches['flash_attention']} flash launches, expected "
                             f"{n_attn}")
    if lk.shape != (SSM_BATCH, AUDIO_FRAMES, cfg.vocab_size) or not bool(
            torch.isfinite(lk).all()):
        raise AssertionError(f"16d: logits {tuple(lk.shape)} not finite")
    if not same:
        raise AssertionError("16d: two forwards of the same frames differ")
    model32 = Transformer.from_params(dataclasses.replace(cfg, dtype="float32"),
                                      model.state_dict(), device=dev)
    del model
    with torch.inference_mode():
        l32, _ = model32(frames, use_kernel=False)
    del model32
    dists = _logit_dists(lk, lp, l32)
    judge_logits("16d every frame's logits", dists)
    del lk, lp, l32
    torch.cuda.empty_cache()

    tcfg = dataclasses.replace(cfg, n_periods=AUDIO_TRAIN_PERIODS)
    expected = 2 * AUDIO_TRAIN_PERIODS * 3
    log(f"phase 16d train: three make_train_step steps of {tcfg.name} at full width cut to "
        f"{tcfg.n_periods} periods ({_param_count(tcfg):,} parameters), one batch of "
        f"{SSM_BATCH} x {AUDIO_FRAMES} frames and labels, remat {tcfg.remat_policy}, "
        "AdamW(peak_lr=3e-4, warmup_steps=1) with fp32 moments")
    torch.cuda.reset_peak_memory_stats()
    model = Transformer(tcfg, device=dev, seed=0)
    opt = AdamW(peak_lr=3e-4, warmup_steps=1, total_steps=10)
    state = opt.init(dict(model.named_parameters()))
    step = make_train_step(opt)
    batch = {"frames": frames, "labels": torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (SSM_BATCH, AUDIO_FRAMES)), dtype=torch.long, device=dev)}
    ops.reset_launch_counts()
    losses, seconds = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        loss, state = step(model, state, batch)
        losses.append(float(loss))
        seconds.append(time.perf_counter() - t0)
    train_launches = ops.launch_counts()
    train_peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"  losses {losses}; step seconds {[round(x, 4) for x in seconds]}; peak memory "
        f"{train_peak:.2f} GB; kernel launches {train_launches} (expected {expected}: forward "
        "and remat recompute a layer a step)")
    if not (np.isfinite(losses).all() and losses[2] < losses[0]):
        raise AssertionError(f"16d: losses {losses} not finite and falling")
    if train_launches["flash_attention"] != expected:
        raise AssertionError(f"16d: {train_launches['flash_attention']} flash launches in "
                             f"training, expected {expected}")
    del model, state, batch, frames
    torch.cuda.empty_cache()
    return launches, train_launches, dict(
        forward_first_s=first_s, forward_s=fwd_s, profile=prof, flash_ms=flash_ms,
        peak_memory_gb=peak_gb, logits=dists, train_losses=losses,
        train_step_seconds=seconds, train_peak_memory_gb=train_peak)


def main_path_families(dev):
    t0 = time.perf_counter()
    xlstm_launches, xlstm = xlstm_serve(dev)
    jamba_launches, jamba = jamba_block(dev)
    vlm_launches, vlm = main_path_serve(dev, VLM_ARCH, "16c")
    audio_launches, train_launches, audio = hubert_encoder(dev)
    out = dict(xlstm=xlstm, jamba=jamba, qwen2_vl=vlm, hubert=audio,
               seconds=time.perf_counter() - t0)
    log(f"  phase 16: {out['seconds']:.1f} s")
    return out, dict(xlstm=xlstm_launches, jamba=jamba_launches, vlm=vlm_launches,
                     hubert=audio_launches, hubert_train=train_launches)


# ---------------------------------------------------------------------------
# Phase 17: the dry run and the sharding layer
# ---------------------------------------------------------------------------

OPT_BATCH, OPT_PROMPT, OPT_GEN = 4, 2048, 32  # phase 6's serving shape
DRYRUN_ARCH = "qwen3-8b"  # 17c's cells: one train, one prefill, one decode
DRYRUN_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
DRYRUN_TIMEOUT_S = 180
MESH_TRAIN_PERIODS, MESH_TRAIN_STEPS = 2, 2

DRYRUN_PROGRAM = """
import json, sys, time
import torch
from repro_torch.launch import dryrun
t0 = time.perf_counter()
for i, shape in enumerate(json.loads(sys.argv[3])):
    recs = dryrun.main(["--arch", sys.argv[2], "--shape", shape, "--out", sys.argv[1]]
                       + (["--oavi"] if i == 0 else []))
print(json.dumps(dict(records=len(recs), cuda_initialized=torch.cuda.is_initialized(),
                      seconds=time.perf_counter() - t0)))
"""


def dense_matmul_flops(cfg, shape) -> int:
    """Every product of a dense attention + MLP cell, 2 m n k each, counted
    by hand: per token a period's q, k, v, o projections and the SwiGLU's
    three; per head of a sequence the scores and the weighted sum over every
    key (the plain attention masks, it does not skip); the unembedding of
    every position (train) or of the last (prefill, decode).  Train is 3
    forwards (each product's two in the backward) and remat's recompute of
    each period, which stops before the period's last product (the MLP's
    down projection, whose output the backward does not need)."""
    d, H, Hkv, dh, ff = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_ff
    B, S = shape.global_batch, shape.seq_len
    T = B if shape.kind == "decode" else B * S
    Sq = 1 if shape.kind == "decode" else S
    period = 2 * T * (d * H * dh + 2 * d * Hkv * dh + H * dh * d + 3 * d * ff) \
        + 4 * B * H * Sq * S * dh
    forward = cfg.n_periods * period \
        + 2 * (T if shape.kind == "train" else B) * d * cfg.vocab_size
    if shape.kind != "train":
        return forward
    return 3 * forward + cfg.n_periods * (period - 2 * T * ff * d)


def run_dryrun():
    """17c: ``python -m repro_torch.launch.dryrun`` on one train, one prefill
    and one decode cell of Qwen3-8B and the OAVI degree step, in a
    subprocess that must not initialize CUDA.  Each Qwen3-8B cell's count
    is held to the products counted by hand, exactly; the OAVI step's
    all-reduce to (L K + K K) fp32 words.  The rest of the grid (the SSM
    cells' meta runs take minutes of host time) is left to the CLI and the
    CPU tests."""
    import tempfile

    from repro_torch import configs

    log(f"phase 17c: python -m repro_torch.launch.dryrun --arch {DRYRUN_ARCH} --shape "
        f"{'|'.join(DRYRUN_SHAPES)} --oavi (pod16x16, meta tensors)")
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"), OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = subprocess.run([sys.executable, "-c", DRYRUN_PROGRAM, tmp, DRYRUN_ARCH,
                              json.dumps(DRYRUN_SHAPES)], capture_output=True, text=True,
                             env=env, cwd=HERE, timeout=DRYRUN_TIMEOUT_S)
        if out.returncode != 0:
            raise AssertionError(f"17c: the dry run exited {out.returncode}: "
                                 f"{(out.stdout + out.stderr)[-3000:]}")
        with open(os.path.join(tmp, "dryrun_torch_pod16x16.json")) as f:
            recs = {(r["arch"], r["shape"]): r for r in json.load(f)}
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    log(f"  {summary['records']} records in {summary['seconds']:.1f} s of its own "
        f"({time.perf_counter() - t0:.1f} s with the process); CUDA initialized there: "
        f"{summary['cuda_initialized']}")
    if summary["cuda_initialized"] or len(recs) != len(DRYRUN_SHAPES) + 1:
        raise AssertionError(f"17c: {len(recs)} records, CUDA initialized "
                             f"{summary['cuda_initialized']}")
    cfg = configs.get_config(DRYRUN_ARCH)
    flops = {}
    for shape in DRYRUN_SHAPES:
        r = recs[(DRYRUN_ARCH, shape)]
        want = dense_matmul_flops(cfg, configs.SHAPES[shape])
        log(f"  {DRYRUN_ARCH} {shape}: flops_total {r['flops_total']:.6e} (by hand "
            f"{want:.6e}), bytes/device {r['bytes_accessed']:.6e}, arguments/device "
            f"{r['memory']['argument_size_bytes']}, {r['time_count_s']} s")
        if r["flops_total"] != want:
            raise AssertionError(f"17c: {shape} counted {r['flops_total']} flops, "
                                 f"the products make {want}")
        flops[shape] = r["flops_total"]
    coll = recs[(DRYRUN_ARCH, "train_4k")]["collective_bytes"]
    log(f"  {DRYRUN_ARCH} train_4k collective bytes a device (the plan's, over the data axis "
        f"and the model axis's Megatron plan): {coll}")
    if not coll["all-gather"] > 0:
        raise AssertionError(f"17c: the train cell's collective bytes are off: {coll}")
    oavi = recs[("oavi-gram-step", "m4M_n57_L256_K64")]
    if not oavi["flops"] > 0 or oavi["collective_bytes"]["all-reduce"] != (256 * 64 + 64 * 64) * 4:
        raise AssertionError(f"17c: the OAVI record is off: {oavi}")
    return dict(records=len(recs), seconds=summary["seconds"], flops_total=flops,
                oavi_flops=oavi["flops"])


def _set_attn_impl(model, impl):
    for blk in model.blocks:
        if hasattr(blk, "dims") and hasattr(blk.dims, "impl"):
            blk.dims = blk.dims._replace(impl=impl)


def _prefill_turns(model, prompts, S_max):
    """Host seconds (synchronized) of the chunked and the flash prefill on
    the same weights, in turns chunked, flash, flash, chunked, after one
    warm call of each."""
    import torch

    times = {"chunked": [], "reference": []}
    for impl in ("chunked", "reference", "reference", "chunked", "chunked", "reference",
                 "reference", "chunked"):
        _set_attn_impl(model, impl)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill(prompts, S_max)
        torch.cuda.synchronize()
        times[impl].append(time.perf_counter() - t0)
    _set_attn_impl(model, "chunked")
    return {("flash" if k == "reference" else k): float(np.median(v[1:]))
            for k, v in times.items()}


def optimized_qwen(dev, p6):
    """17a: ``get_optimized("qwen3-8b")`` served at phase 6's shape, then
    held against phase 6's flash-path logits."""
    import torch

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.models.model import Transformer

    cfg = configs.get_optimized("qwen3-8b")
    log(f"phase 17a: serve get_optimized('qwen3-8b') (attn_impl {cfg.attn_impl}, attn_chunk "
        f"{cfg.attn_chunk}) at full width and depth, batch {OPT_BATCH}, prompt {OPT_PROMPT}, "
        f"{OPT_GEN} generated, seed 0")
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    out = serve(cfg, batch=OPT_BATCH, prompt_len=OPT_PROMPT, gen_tokens=OPT_GEN, seed=0)
    launches = ops.launch_counts()
    log(f"  serve: prefill {out['prefill_s']:.4f} s (phase 6's flash prefill "
        f"{p6['prefill_s']:.4f} s); decode {out['decode_s']:.4f} s, {out['tokens_per_s']:.2f} "
        f"tokens/s; kernel launches {launches}")
    if launches["flash_attention"]:
        raise AssertionError("17a: the chunked prefill launched the flash kernel")
    model = Transformer(cfg, device=dev, seed=0)
    prompts = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (OPT_BATCH, OPT_PROMPT)), dtype=torch.long, device=dev)
    S_max = OPT_PROMPT + OPT_GEN
    with torch.inference_mode():
        lc, _ = model.prefill(prompts, S_max)
        turns = _prefill_turns(model, prompts, S_max)
    del model
    torch.cuda.empty_cache()
    chunked = lc[:, -1].float().cpu()
    if not bool(torch.isfinite(chunked).all()) or chunked.shape[-1] != cfg.vocab_size:
        raise AssertionError("17a: chunked logits not finite of the vocabulary's width")
    d_flash = float((chunked - p6["flash"]).abs().max())
    d_fp32 = float((chunked - p6["fp32"]).abs().max())
    limit = LM_FACTOR * p6["plain_vs_fp32"]
    log(f"  prefill last-token logits: chunked vs phase 6's flash {d_flash:.6g}, chunked vs "
        f"fp32 {d_fp32:.6g}, phase 6's plain bf16 vs fp32 {p6['plain_vs_fp32']:.6g} (limit "
        f"{limit:.6g}); same top-1: {bool(torch.equal(chunked.argmax(-1), p6['flash'].argmax(-1)))}")
    log(f"  warm prefill on the same weights, in turns (median of 3, host s synchronized): "
        f"chunked {turns['chunked']:.4f}, flash {turns['flash']:.4f} "
        f"(chunked / flash {turns['chunked'] / turns['flash']:.2f})")
    if d_flash > limit or d_fp32 > limit:
        raise AssertionError("17a: the chunked model's logits are off")
    return dict(serve_prefill_s=out["prefill_s"], flash_serve_prefill_s=p6["prefill_s"],
                decode_s=out["decode_s"], tokens_per_s=out["tokens_per_s"],
                warm_prefill_s=turns, chunked_vs_flash=d_flash, chunked_vs_fp32=d_fp32,
                limit=limit)


def optimized_deepseek(dev, p15):
    """17b: ``get_optimized("deepseek-v2-lite-16b")`` at full width and
    depth, routes pinned to phase 15a's prefill, against 15a's flash
    logits."""
    import torch

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    from repro_torch.models.model import Transformer

    cfg = configs.get_optimized(MLA_ARCH)
    T = MOE_BATCH * MOE_PROMPT
    log(f"phase 17b: get_optimized('{MLA_ARCH}') at full width and depth (chunked MLA at d "
        f"{cfg.mla.qk_nope_dim + cfg.mla.qk_rope_dim} / dv {cfg.mla.v_head_dim}, chunks of "
        f"{cfg.attn_chunk}; MoE dispatch {cfg.moe.dispatch}, {moe.rows_of(T, cfg.moe)} row), "
        f"batch {MOE_BATCH}, prompt {MOE_PROMPT}, seed 0, routes pinned to phase 15a's")
    if moe.rows_of(T, cfg.moe) != 1:
        raise AssertionError("17b: rowwise dispatch without a mesh must have one row")
    torch.cuda.empty_cache()
    model = Transformer(cfg, device=dev, seed=0)
    prompts = _prompts(cfg, dev)
    S_max = MOE_PROMPT + MOE_GEN
    ops.reset_launch_counts()
    with torch.inference_mode():
        with MoEProbe(replay=[r.to(dev) for r in p15["routes"]]):
            lc, _ = model.prefill(prompts, S_max)
        launches = ops.launch_counts()
        turns = _prefill_turns(model, prompts, S_max)
    del model
    torch.cuda.empty_cache()
    chunked = lc[:, -1].float().cpu()
    if not bool(torch.isfinite(chunked).all()) or chunked.shape[-1] != cfg.vocab_size:
        raise AssertionError("17b: chunked logits not finite of the vocabulary's width")
    gap = float((chunked - p15["flash"]).abs().max())
    limit = LM_FACTOR * p15["plain_gap"]
    log(f"  prefill last-token logits, routes pinned: chunked vs 15a's flash {gap:.6g}, 15a's "
        f"plain vs flash {p15['plain_gap']:.6g} (limit {limit:.6g}); kernel launches {launches}")
    log(f"  warm prefill on the same weights, in turns (median of 3, unpinned): chunked "
        f"{turns['chunked']:.4f} s, flash {turns['flash']:.4f} s (15a's served flash prefill "
        f"{p15['prefill_s']:.4f} s)")
    if launches["flash_attention"]:
        raise AssertionError("17b: the chunked prefill launched the flash kernel")
    if gap > limit:
        raise AssertionError("17b: the chunked model's logits are off")
    return dict(chunked_vs_flash=gap, limit=limit, warm_prefill_s=turns)


def train_under_mesh(dev):
    """17d: ``launch.train.train`` under ``make_local_mesh()`` and with no
    mesh: the same losses, bit for bit."""
    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.train import train

    cfg = dataclasses.replace(configs.get_config(TRAIN_ARCH), n_periods=MESH_TRAIN_PERIODS)
    log(f"phase 17d: launch.train.train({cfg.name} cut to {MESH_TRAIN_PERIODS} periods, "
        f"{MESH_TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ}) under make_local_mesh() and "
        "with mesh=None, torch.use_deterministic_algorithms(True, warn_only=True)")
    kw = dict(steps=MESH_TRAIN_STEPS, global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, seed=0,
              log_every=MESH_TRAIN_STEPS)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        mesh = make_local_mesh()
        log(f"  mesh {mesh} (backend {dist.get_backend()}, world {dist.get_world_size()})")
        with_mesh = train(cfg, mesh=mesh, **kw)["losses"]
        without = train(cfg, mesh=None, **kw)["losses"]
    finally:
        torch.use_deterministic_algorithms(False)
        if dist.is_initialized():
            dist.destroy_process_group()
    log(f"  losses under the mesh {with_mesh}, without {without}; bit-equal: "
        f"{with_mesh == without}")
    if with_mesh != without or not all(np.isfinite(with_mesh)):
        raise AssertionError("17d: training under the local mesh changed the losses")
    return dict(losses=with_mesh)


def main_path_optimized(dev, p6, p15):
    t0 = time.perf_counter()
    qwen = optimized_qwen(dev, p6)
    deepseek = optimized_deepseek(dev, p15)
    dry = run_dryrun()
    mesh_train = train_under_mesh(dev)
    out = dict(qwen3_8b=qwen, deepseek=deepseek, dryrun=dry, mesh_train=mesh_train,
               seconds=time.perf_counter() - t0)
    log(f"  phase 17: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 18: LM serving and training over two ranks (torch.distributed)
# ---------------------------------------------------------------------------

MESH_RANKS = 2
MESH_SERVE_PROMPT, MESH_SERVE_GEN = 1024, 32
MESH_STEPS, MESH_MOE_STEPS = 3, 2
MESH_LR = 3e-4
MESH_TIMEOUT_S = 600
# 18b-c: two ranks against one device, the same bf16 weights and batches.
# Each rank's products run on half the rows, and its bf16 gradients are
# summed over the ranks and halved where one device sums every row at once:
# each gradient entry moves by a few bf16 roundings (2^-8 relative).  At lr
# 3e-4 a bf16 weight takes an update of ~2-3 units in its last place, so
# some updates round one unit apart.  Both limits lie between the readings
# of the sound runs and those of the controls (PERF.md).  Losses: the sound
# runs' up to 2.3e-5 from one device's, 18b's controls' 1.3e-4 and more;
# one update moves the next loss by only ~1.5e-4, so the losses cannot
# tell every wrong update (18c's unreduced control reads 1.1e-5): the
# parameters decide.
MESH_LOSS_RTOL = 6e-5
# |P - P1| / |P1 - P0| over every parameter entry, in fp32: P the ranks'
# parameters after the steps (every rank's blocks), P1 one device's, P0 the initial
# ones.  The sound runs read 0.020 (18b) and 0.017 (18c), their unreduced
# controls 0.92 and 0.98.
MESH_PARAM_RTOL = 0.1
# 18b: what a rank's torch.cuda.memory_allocated() grew by from before its
# train state was built, read between steps, against the plan's at-rest
# bytes (blocks, replicated leaves, fp32 moment blocks): the rest is the
# backward thread's cuBLAS workspace (32 MiB, allocated in the first step)
# and the next batch
AT_REST_RTOL = 0.05

# 18d-e: the per-period schedule at full width, 2 x 1,024 tokens a
# step (one row a rank).  18d: Qwen2-1.5B at full depth, 18b's gates against
# one device; 18e: DeepSeek-V2-Lite cut to the fewest periods at which the
# plan's bytes say two ranks of the whole-gather step do not fit the card
# and two of the per-period step fit with MESH_FIT_SPARE of it to spare
MESH_FULL_BATCH, MESH_FULL_SEQ, MESH_FULL_STEPS, MESH_FIT_STEPS = 2, 1024, 2, 1
MESH_FIT_SPARE = 0.15


def _block_entries(plan, name):
    """The entries of a rank's block of a leaf (its share at rest)."""
    leaf = plan.leaves[name]
    return (math.prod(leaf.shape) // (1 if leaf.dim is None else plan.shards)
            // (1 if leaf.mdim is None else plan.model))


def step_peak_parts(cfg, rows, seq, plan):
    """What a rank's train step allocates at most above its start, in its
    two phases.  ``backward``: the plan's bound on its full tensors
    (``plan.held_bound()``), each period's bf16 input kept by remat, the
    two threads' 32 MiB cuBLAS workspaces, and the larger of the CE's
    vocabulary tensors at their peak (20 bytes a logit: the bf16 logits, an
    fp32 copy, ``logits - max``, its exp, and in the backward the exp saved
    beside two fp32 gradients and the bf16 one) and, later, the
    synchronised gradients (every leaf's block) beside one sub-block's
    recompute and backward (the plain attention backward's six fp32
    score-sized tensors, or eight bf16 tensors of the widest MLP / expert
    hidden layer) and a gather's staging (the moved block, the gathered
    tensor and its contiguous copy: three of the largest compute tensor).
    ``update`` (the gathered tensors freed): the synchronised gradients and
    AdamW's temporaries for its largest leaf, 24 bytes an entry (the scaled
    gradient, its fp32 copy, the update, the fp32 parameter and two
    temporaries of the last line)."""
    T = rows * seq
    ce = 20 * T * cfg.vocab_size // (plan.model if plan.vocab_cut else 1)
    inputs = cfg.n_periods * T * cfg.d_model * 2
    heads = cfg.mla.n_heads if cfg.mla is not None else cfg.n_heads
    attn = 6 * rows * heads * seq * seq * 4
    hidden = 2 * max(cfg.d_ff, cfg.moe.top_k * cfg.moe.d_ff if cfg.moe else 0)
    block = max(attn, 8 * T * hidden * 2)
    staging = 3 * max((plan._compute_bytes(k) for k in plan._stepped()), default=0)
    grads = sum(_block_entries(plan, k) * leaf.dtype.itemsize for k, leaf in plan.leaves.items())
    largest = max(math.prod(leaf.shape) if plan.whole_moments else _block_entries(plan, k)
                  for k, leaf in plan.leaves.items())
    workspace = 2 * 32 * 2 ** 20
    return dict(backward=plan.held_bound() + inputs + workspace
                + max(ce, grads + block + staging),
                update=grads + 24 * largest + workspace)


def step_peak_prediction(cfg, rows, seq, plan):
    """The bytes a rank's train step allocates at most above its start: the
    larger of :func:`step_peak_parts`."""
    return max(step_peak_parts(cfg, rows, seq, plan).values())


def fit_periods(arch, ranks, card_bytes, spare=MESH_FIT_SPARE):
    """The fewest periods of ``arch`` at full width at which ``ranks`` ranks
    of the whole-gather step (at-rest bytes, every leaf's gathered weights
    and gradients, the rest of :func:`step_peak_prediction`) do not fit
    ``card_bytes`` and as many of the per-period step (at rest, the
    prediction) fit with
    ``spare`` of it to spare, by the plans' arithmetic on meta: ``(periods,
    what each needs)``."""
    from repro_torch import configs
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models import model as M
    from repro_torch.runtime.data_parallel import DataParallelPlan

    rows = MESH_FULL_BATCH // ranks
    for n in range(1, configs.get_config(arch).n_periods + 1):
        cfg = _mesh_cut(arch, n)
        plan = DataParallelPlan(cfg, M.abstract_params(cfg),
                                AbstractMesh((ranks, 1), ("data", "model")), _mesh_opt(1))
        act = step_peak_prediction(cfg, rows, MESH_FULL_SEQ, plan) - plan.held_bound()
        whole = ranks * (plan.at_rest_bytes() + plan.whole_step_bytes() + act)
        change = ranks * (plan.at_rest_bytes() + plan.held_bound() + act)
        if whole > card_bytes and change <= (1 - spare) * card_bytes:
            return n, dict(whole_gather=whole, per_period=change, card=card_bytes)
    raise AssertionError(f"{arch}: no cut that only the per-period step fits on the card")


MESH_RANK_PROGRAM = """
import datetime, json, os, sys, time
import numpy as np
import torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

rank, world, work, here = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", store=dist.FileStore(os.path.join(work, "store"), world),
                        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=240))
try:
    sys.path.insert(0, here)
    import chip_smoke as C
    C.mesh_rank(rank, world, work)
finally:
    dist.destroy_process_group()
"""


def _checksum(tensors) -> str:
    """SHA-256 of the tensors' bytes, in turn."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def _mesh_cut(cfg_name, periods):
    from repro_torch import configs

    return dataclasses.replace(configs.get_config(cfg_name), n_periods=periods)


def _mesh_opt(steps, lr=MESH_LR, quantize=False):
    """18b-c's AdamW: no warm-up step (the first step's learning rate is
    already ``lr``), so each loss after the first reads an update; 20d's with
    8-bit moments."""
    from repro_torch.optim import AdamW

    return AdamW(peak_lr=lr, warmup_steps=0, total_steps=steps, quantize_states=quantize)


def _replaying(ids):
    return contextlib.nullcontext() if ids is None else MoEProbe(replay=ids)


def _gap_parts(plan, params, one):
    """Each leaf's ``|P - P1|^2``, in fp32, summed over the mesh from every
    rank's blocks (each block once, ``plan._owns``): ``params`` a rank's
    blocks after a run's steps (P), ``one`` the one-device run's file, its
    parameters after its steps (``p1``, cut here to the rank's blocks) and
    each leaf's ``|P1 - P0|^2`` (``dens``, P0 the initial ones).  Nothing of
    P is gathered: a 2.9 B model's gather through gloo took longer than its
    steps (PR 28 call 3)."""
    import torch

    names = sorted(params)
    parts = torch.zeros(len(names), dtype=torch.float32, device="cuda")
    for i, k in enumerate(names):
        if plan._owns(plan.leaves[k]):
            p1 = plan.cut(k, one["p1"][k]).to("cuda", torch.float32)
            parts[i] = torch.sum(torch.square(params[k].float() - p1))
    if plan.ranks > 1:
        plan.comm.all_reduce(parts, plan.mesh_group)
    return dict(zip(names, parts.tolist()))


def _param_gap(parts, one) -> float:
    """``|P - P1| / |P1 - P0|`` over every entry."""
    return math.sqrt(sum(parts.values()) / sum(one["dens"].values()))


def _leaf_gap(parts, one):
    """The largest ``|P - P1| / |P1 - P0|`` of one leaf, and that leaf."""
    gaps = {k: math.sqrt(v / one["dens"][k]) if one["dens"][k] else (math.inf if v else 0.0)
            for k, v in parts.items()}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def _gap_leaves(parts, n=4):
    """The ``n`` leaves that add most to :func:`_param_gap`'s numerator, each
    with its share of it."""
    total = sum(parts.values()) or 1.0
    top = sorted(parts, key=parts.get, reverse=True)[:n]
    return [(k, round(parts[k] / total, 4)) for k in top]


class _PhasedOpt:
    """``opt`` whose ``update`` first turns the last entry of ``phases``
    (the bytes allocated at the step's start) into the step's peak above
    it so far, and starts the peak count again for the update."""

    def __init__(self, opt, phases):
        self._opt, self._phases = opt, phases

    def __getattr__(self, name):
        return getattr(self._opt, name)

    def update(self, *args, **kwargs):
        import torch

        self._phases.append(torch.cuda.max_memory_allocated() - self._phases.pop())
        torch.cuda.reset_peak_memory_stats()
        return self._opt.update(*args, **kwargs)


def _rank_train(cfg, mesh, steps, one, *, replay=None, unreduced=False, control=None,
                quantize=False, batch=TRAIN_BATCH, seq=TRAIN_SEQ, batch_fn=None):
    """``steps`` steps of ``cfg`` on this rank's rows through
    ``make_sharded_train_state`` / ``make_step`` (18b-c), ``replay``'s route
    ids replayed: the losses, step and collective seconds, the bytes
    allocated above the level before the state (before and between steps),
    the launches and collectives of the steps, the checksum of the leaves a
    rank holds whole (every rank's equal) and, given ``one``, the
    parameters' distance from one device's (every rank calls it).
    ``unreduced`` is the control: each sharded leaf's gradient left
    unreduced (this rank's block of its own gradient, over the world),
    as a reduce_scatter that returned only the local sum would; ``control``
    names a :class:`TPControl` patched in for the steps (phases 19-20).
    ``batch`` x ``seq`` tokens a step, or ``batch_fn(step)``'s batch (20c's
    frames); ``quantize``: 8-bit moments (20d).  Each step's
    ``max_memory_allocated`` above the bytes allocated before it
    (``peak``), and the plan's held-bytes peak over the steps beside its
    bound, the whole-gather figure and the predicted peak (18d-e)."""
    import torch

    from repro_torch.data import lm as lm_data
    from repro_torch.kernels import ops
    from repro_torch.launch.train import make_sharded_train_state, make_step

    opt = _mesh_opt(steps, quantize=quantize)
    pipe = lm_data.PipelineConfig(vocab_size=cfg.vocab_size, seq_len=seq + 1,
                                  global_batch=batch, seed=0)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()  # this process's before the state exists
    model, params, st, plan = make_sharded_train_state(cfg, opt, mesh, seed=0)
    if unreduced:  # the plan's seam a leaf: inside each period's backward, or after it
        plan.sync_grad = lambda k, g: (plan.comm.all_reduce(g, plan.batch_group)
                                       if plan.leaves[k].dim is None
                                       else plan.cut(k, g)).div_(plan.world)
    phases = []  # each step's peak above its start before the update, then in it
    step = make_step(model, _PhasedOpt(opt, phases), plan)
    torch.cuda.synchronize()
    rest = [torch.cuda.memory_allocated() - held]
    ops.reset_launch_counts()
    plan.comm.reset()
    plan.reset_held()
    losses, step_s, coll_s, peak = [], [], [], []
    fault = TPControl(control) if control else contextlib.nullcontext()
    with _replaying(replay), fault:
        for i in range(steps):
            rows = (batch_fn(i) if batch_fn else
                    {"tokens": lm_data.batch_for_mesh(pipe, i, mesh, device="cuda")})
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            phases.append(before)
            c0, t0 = plan.comm.seconds, time.perf_counter()
            loss, params, st = step(params, st, rows)
            losses.append(float(loss))
            step_s.append(time.perf_counter() - t0)
            coll_s.append(plan.comm.seconds - c0)
            phases.append(torch.cuda.max_memory_allocated() - before)
            peak.append(max(phases[-2:]))
            del rows
            torch.cuda.synchronize()
            rest.append(torch.cuda.memory_allocated() - held)
    launches, issued = ops.launch_counts(), dict(plan.comm.bytes)
    rows_n = batch // plan.world
    out = dict(losses=losses, step_s=step_s, collective_s=coll_s, allocated=rest,
               at_rest=plan.at_rest_bytes(), launches=launches, issued=issued,
               want=plan.collective_bytes("train", batch, seq),
               checksum=_checksum(params[k] for k in sorted(params) if plan._whole(k)),
               sharded=len(plan.sharded()), leaves=len(plan.leaves), peak=peak,
               held_peak=plan.held_peak, held_bound=plan.held_bound(),
               whole_step=plan.whole_step_bytes(), per_period=len(plan.per_period),
               phases=[phases[i:i + 2] for i in range(0, len(phases), 2)],
               predicted=step_peak_prediction(cfg, rows_n, seq, plan),
               predicted_parts=step_peak_parts(cfg, rows_n, seq, plan))
    if one:
        parts = _gap_parts(plan, params, one)
        out.update(param_gap=_param_gap(parts, one), leaf_gap=_leaf_gap(parts, one),
                   gap_leaves=_gap_leaves(parts))
    del model, params, st
    torch.cuda.empty_cache()
    return out


def mesh_rank(rank, world, work):
    """One rank of phase 18 (two gloo ranks on the one card): 18a serves,
    18b trains the dense cut and 18c the MoE cut (the one-device run's
    routes replayed), each then again as the unreduced control.  Writes
    what it got to ``work/rank<rank>.pt``."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve

    torch.cuda.set_device(0)
    mesh = init_device_mesh("cuda", (world, 1), mesh_dim_names=("data", "model"))
    out = {}

    # 18a: serve Qwen2-1.5B, this rank's rows of the prompt batch; serve's
    # own prefill logits of them go back
    cfg = configs.get_config(TRAIN_ARCH)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    served = serve(cfg, batch=TRAIN_BATCH, prompt_len=MESH_SERVE_PROMPT,
                   gen_tokens=MESH_SERVE_GEN, seed=0, mesh=mesh)
    serve_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    out["serve"] = dict(logits=served["prefill_logits"].float().cpu(),
                        generated=served["generated"], prefill_s=served["prefill_s"],
                        decode_s=served["decode_s"], tokens_per_s=served["tokens_per_s"],
                        serve_s=serve_s, launches=launches)
    del served
    torch.cuda.empty_cache()

    # 18b and 18c, each with its control; rank 0 measures the parameters'
    # distance from one device's
    n = TRAIN_BATCH // world
    for key, cfg, steps in (("train", _mesh_cut(TRAIN_ARCH, MESH_TRAIN_PERIODS), MESH_STEPS),
                            ("moe", _mesh_cut(MLA_ARCH, 2), MESH_MOE_STEPS)):
        one = torch.load(os.path.join(work, f"one_{key}.pt"), mmap=True)
        replay = None
        if key == "moe":  # this rank's rows of each route call's ids
            ids = torch.load(os.path.join(work, "moe_ids.pt"), map_location="cuda")
            replay = [e[rank * n * TRAIN_SEQ:(rank + 1) * n * TRAIN_SEQ] for e in ids]
        out[key] = _rank_train(cfg, mesh, steps, one, replay=replay)
        out[key + "_control"] = _rank_train(cfg, mesh, steps, one, replay=replay,
                                            unreduced=True)
        del one
    # 18d: Qwen2-1.5B at full width and depth; 18e: DeepSeek-V2-Lite at full
    # width cut to the periods main_path_mesh chose, with nothing to compare
    # on one device
    kw = dict(batch=MESH_FULL_BATCH, seq=MESH_FULL_SEQ)
    one = torch.load(os.path.join(work, "one_full.pt"), mmap=True)
    out["full"] = _rank_train(configs.get_config(TRAIN_ARCH), mesh, MESH_FULL_STEPS, one, **kw)
    del one
    with open(os.path.join(work, "fit.json")) as f:
        periods = json.load(f)["periods"]
    out["fit"] = _rank_train(_mesh_cut(MLA_ARCH, periods), mesh, MESH_FIT_STEPS, None, **kw)
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))


def _one_device_train(cfg, lr, steps, dev, work=None, key=None, *, quantize=False,
                      batch=TRAIN_BATCH, seq=TRAIN_SEQ, batch_fn=None, params=None):
    """``steps`` steps of ``cfg`` on one device through the ranks' pieces
    (``mesh=None``): the losses and step seconds; with ``work``, the
    parameters after the steps and each leaf's squared distance from the
    initial ones to ``work/one_<key>.pt`` (:func:`_gap_parts`' reference).
    The batch and the moments as :func:`_rank_train`'s; ``params`` (a state
    dict) replaces the seed's initial weights."""
    import torch

    from repro_torch.data import lm as lm_data
    from repro_torch.launch.train import make_sharded_train_state, make_step

    opt = _mesh_opt(steps, lr, quantize)
    pipe = lm_data.PipelineConfig(vocab_size=cfg.vocab_size, seq_len=seq + 1,
                                  global_batch=batch, seed=0)
    model, params, st, plan = make_sharded_train_state(cfg, opt, None, seed=0, device=dev,
                                                       params=params)
    p0 = {k: v.detach().clone() for k, v in params.items()} if work else None
    step = make_step(model, opt, plan)
    losses, step_s = [], []
    for i in range(steps):
        rows = (batch_fn(i) if batch_fn else
                {"tokens": lm_data.batch_for_mesh(pipe, i, None, device=dev)})
        t0 = time.perf_counter()
        loss, params, st = step(params, st, rows)
        losses.append(float(loss))
        step_s.append(time.perf_counter() - t0)
    if work:
        dens = {k: float(torch.sum(torch.square(params[k].detach().float() - p0[k].float())))
                for k in params}
        torch.save(dict(p1={k: v.detach().cpu() for k, v in params.items()}, dens=dens),
                   os.path.join(work, f"one_{key}.pt"))
    del model, params, st, p0
    torch.cuda.empty_cache()
    return losses, step_s


def mesh_one_device(dev, work):
    """18a-c's one-device runs: Qwen2-1.5B's served tokens and prefill
    logits (bf16 through the kernel, and an fp32 copy); the dense and the
    MoE cut's losses and parameters (to ``work``), the MoE's route ids
    recorded; and the dense cut at learning rate 0 (a control)."""
    import torch

    from repro_torch import configs
    from repro_torch.launch.serve import serve
    from repro_torch.models.model import Transformer

    cfg = configs.get_config(TRAIN_ARCH)
    served = serve(cfg, batch=TRAIN_BATCH, prompt_len=MESH_SERVE_PROMPT,
                   gen_tokens=MESH_SERVE_GEN, seed=0)
    model = Transformer(cfg, device=dev, seed=0)
    prompts = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, MESH_SERVE_PROMPT)), device=dev)
    S_max = MESH_SERVE_PROMPT + MESH_SERVE_GEN
    with torch.inference_mode():
        lk, _ = model.prefill(prompts, S_max)
        model32 = Transformer.from_params(dataclasses.replace(cfg, dtype="float32"),
                                          model.state_dict(), device=dev)
        del model
        l32, _ = model32.prefill(prompts, S_max, use_kernel=False)
        del model32
    one = dict(generated=served["generated"], prefill_s=served["prefill_s"],
               decode_s=served["decode_s"], logits=lk[:, -1].float().cpu(),
               fp32=l32[:, -1].float().cpu())
    del lk, l32, served
    torch.cuda.empty_cache()
    cut = _mesh_cut(TRAIN_ARCH, MESH_TRAIN_PERIODS)
    dense, dense_s = _one_device_train(cut, MESH_LR, MESH_STEPS, dev, work, "train")
    dense_lr0 = _one_device_train(cut, 0.0, MESH_STEPS, dev)[0]
    with MoEProbe() as probe:
        moe_run, moe_s = _one_device_train(_mesh_cut(MLA_ARCH, 2), MESH_LR, MESH_MOE_STEPS,
                                           dev, work, "moe")
    torch.save(probe.ids, os.path.join(work, "moe_ids.pt"))
    full, full_s = _one_device_train(cfg, MESH_LR, MESH_FULL_STEPS, dev, work, "full",
                                     batch=MESH_FULL_BATCH, seq=MESH_FULL_SEQ)
    return dict(serve=one, train=dense, train_step_s=dense_s, train_lr0=dense_lr0,
                moe=moe_run, moe_step_s=moe_s, moe_route_calls=len(probe.ids),
                full=full, full_step_s=full_s)


def run_ranks(tag, program, world, work, timeout=MESH_TIMEOUT_S):
    """``world`` processes of ``program`` (argv: rank, world, work, this
    directory), each a gloo rank on the one card; raises with their errors'
    tails if one fails."""
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    procs = [subprocess.Popen([sys.executable, "-c", program, str(r), str(world), work, HERE],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(world)]
    try:
        errs = [p.communicate(timeout=timeout)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        raise AssertionError(f"{tag}: a rank failed: {[e[-3000:] for e in errs]}")


def main_path_mesh(dev, work):
    """Phase 18: LM serving and training over two gloo ranks on the one card
    (spawned processes; NCCL refuses two ranks on one device), held against
    one-device runs in this process; those runs' parameters and route ids
    stay in ``work`` for phase 19."""
    import torch

    from repro_torch import configs

    t0 = time.perf_counter()
    log(f"phase 18: {MESH_RANKS} gloo ranks on the one card, a (data {MESH_RANKS}, model 1) "
        f"mesh: (a) serve {TRAIN_ARCH} at full width and depth, batch {TRAIN_BATCH} x "
        f"{MESH_SERVE_PROMPT} prompt tokens, {MESH_SERVE_GEN} generated; (b) {TRAIN_ARCH} cut "
        f"to {MESH_TRAIN_PERIODS} periods, {MESH_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} "
        f"(leaves and fp32 moments cut by param_specs/state_specs); (c) {MLA_ARCH} cut to 2 "
        f"periods, {MESH_MOE_STEPS} steps, routes replayed from the one-device run, the aux "
        "loss and the global dispatch plan over both ranks")
    card = torch.cuda.get_device_properties(0).total_memory
    periods, fit_need = fit_periods(MLA_ARCH, MESH_RANKS, card)
    with open(os.path.join(work, "fit.json"), "w") as f:
        json.dump(dict(periods=periods), f)
    log(f"  (d) {TRAIN_ARCH} at full width and depth, {MESH_FULL_STEPS} steps of "
        f"{MESH_FULL_BATCH} x {MESH_FULL_SEQ}; (e) {MLA_ARCH} at full width cut to {periods} "
        f"periods, {MESH_FIT_STEPS} step(s): by the plans' bytes {MESH_RANKS} ranks of the "
        f"whole-gather step need {fit_need['whole_gather']} B and of the per-period step "
        f"{fit_need['per_period']} B of the card's {card}; each period's leaves gathered "
        "inside it (again in its remat recompute), its gradients reduce-scattered as its "
        "backward ends")
    torch.cuda.empty_cache()
    one = mesh_one_device(dev, work)
    np.savez(os.path.join(work, "one_losses.npz"), train=one["train"], moe=one["moe"])
    t1 = time.perf_counter()
    run_ranks("18", MESH_RANK_PROGRAM, MESH_RANKS, work)
    ranks_s = time.perf_counter() - t1
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
             for r in range(MESH_RANKS)]

    # 18a
    cfg = configs.get_config(TRAIN_ARCH)
    n_attn = cfg.n_periods * cfg.period.count("attn")
    ref = one["serve"]
    limit = LM_FACTOR * float((ref["logits"] - ref["fp32"]).abs().max())
    gaps, n = [], TRAIN_BATCH // MESH_RANKS
    for rank, r in enumerate(ranks):  # rank r serves rows [r n, (r + 1) n) of the batch
        if r["serve"]["logits"].shape != (n, cfg.vocab_size):
            raise AssertionError(f"18a: rank {rank}'s prefill logits are "
                                 f"{tuple(r['serve']['logits'].shape)}")
        gaps.append(float((r["serve"]["logits"] - ref["logits"][rank * n:(rank + 1) * n])
                          .abs().max()))
        if r["serve"]["launches"]["flash_attention"] != n_attn:
            raise AssertionError(f"18a: a rank launched flash "
                                 f"{r['serve']['launches']['flash_attention']} times, expected "
                                 f"{n_attn}")
        if r["serve"]["generated"].shape != (TRAIN_BATCH, MESH_SERVE_GEN):
            raise AssertionError("18a: a rank's gathered tokens are not the whole batch's")
    if not np.array_equal(ranks[0]["serve"]["generated"], ranks[1]["serve"]["generated"]):
        raise AssertionError("18a: the ranks returned different tokens")
    differ = int(np.sum(ranks[0]["serve"]["generated"] != ref["generated"]))
    log(f"  18a: serve's prefill last-token logits against the one-device run's rows: max "
        f"|gap| {[round(g, 6) for g in gaps]} (limit {LM_FACTOR} x the one-device bf16 vs fp32 "
        f"gap = {limit:.6g}); generated tokens differing from one device's: {differ} of "
        f"{ref['generated'].size}; rank prefill s {[r['serve']['prefill_s'] for r in ranks]} "
        f"(one device {ref['prefill_s']:.4f}), decode tokens/s "
        f"{[round(r['serve']['tokens_per_s'], 2) for r in ranks]}; flash launches a rank "
        f"{[r['serve']['launches']['flash_attention'] for r in ranks]}")
    if max(gaps) > limit:
        raise AssertionError("18a: a rank's prefill logits are off")

    # 18b-c: the ranks agree bit for bit; their losses and gathered
    # parameters agree with one device's; each control fails the gates
    def loss_gap(losses, ref):
        return float(np.max(np.abs(np.subtract(losses, ref)) / np.abs(ref)))

    n_flash = {"train": 2 * MESH_TRAIN_PERIODS * cfg.period.count("attn") * MESH_STEPS,
               "moe": 2 * 2 * configs.get_config(MLA_ARCH).period.count("mla") * MESH_MOE_STEPS}
    found = {}
    for key, tag in (("train", "18b"), ("moe", "18c")):
        runs, ctrl = [r[key] for r in ranks], ranks[0][key + "_control"]
        gap, ctrl_gap = loss_gap(runs[0]["losses"], one[key]), loss_gap(ctrl["losses"], one[key])
        log(f"  {tag}: losses rank 0 {runs[0]['losses']}, rank 1 {runs[1]['losses']}, one "
            f"device {one[key]} (largest relative gap {gap:.3g}, limit {MESH_LOSS_RTOL}); "
            f"parameters |P - P1| / |P1 - P0| {runs[0]['param_gap']:.6g} (limit "
            f"{MESH_PARAM_RTOL}); control with unreduced sharded gradients: losses "
            f"{ctrl['losses']} (gap {ctrl_gap:.3g}), parameters {ctrl['param_gap']:.6g}; "
            f"checksums equal: {runs[0]['checksum'] == runs[1]['checksum']}; "
            f"{runs[0]['sharded']} of {runs[0]['leaves']} leaves sharded; step seconds a rank "
            f"{[[round(x, 4) for x in t['step_s']] for t in runs]} (one device "
            f"{[round(x, 4) for x in one[key + '_step_s']]}), of which collectives (gloo "
            f"through the host) {[[round(x, 4) for x in t['collective_s']] for t in runs]}; "
            f"bytes allocated above the level before the state, read before and between steps "
            f"{[t['allocated'] for t in runs]}, against the plan's at-rest {runs[0]['at_rest']}; "
            f"collectives issued {runs[0]['issued']}, the plan's a step {runs[0]['want']}; "
            f"flash launches a rank {[t['launches']['flash_attention'] for t in runs]}")
        for t in runs:
            if t["losses"] != runs[0]["losses"] or t["checksum"] != runs[0]["checksum"]:
                raise AssertionError(f"{tag}: the ranks' losses or whole leaves differ")
            if t["launches"]["flash_attention"] != n_flash[key]:
                raise AssertionError(f"{tag}: {t['launches']['flash_attention']} flash "
                                     f"launches, expected {n_flash[key]}")
        if gap > MESH_LOSS_RTOL or not np.isfinite(runs[0]["losses"]).all():
            raise AssertionError(f"{tag}: the two ranks' losses are off the one-device run's")
        if not runs[0]["param_gap"] <= MESH_PARAM_RTOL:
            raise AssertionError(f"{tag}: the two ranks' parameters are off the one-device run's")
        if not ctrl["param_gap"] > MESH_PARAM_RTOL:  # else the gate cannot see a wrong update
            raise AssertionError(f"{tag}: the unreduced control passed the parameter gate "
                                 f"({ctrl['param_gap']})")
        found[key] = dict(losses=runs[0]["losses"], one=one[key], gap=gap,
                          param_gap=runs[0]["param_gap"], control_gap=ctrl_gap,
                          control_param_gap=ctrl["param_gap"],
                          step_s=[t["step_s"] for t in runs],
                          collective_s=[t["collective_s"] for t in runs],
                          issued=runs[0]["issued"])
    # 18b's memory and collectives against the plan, and its lr-0 control
    tr = [r["train"] for r in ranks]
    for t in tr:
        if any(abs(a - t["at_rest"]) > AT_REST_RTOL * t["at_rest"] for a in t["allocated"]):
            raise AssertionError(f"18b: allocated {t['allocated']} between steps, the plan "
                                 f"holds {t['at_rest']}")
        want = {k: v * MESH_STEPS for k, v in t["want"].items() if k != "total"}
        if t["issued"] != want:
            raise AssertionError(f"18b: collectives {t['issued']}, the plan's {want}")
    # 18d-e: the per-period schedule at full width: the step's peak
    # allocation a rank above its at-rest bytes against the prediction and
    # the plan's held-bytes count against its bound; 18d against one device
    per_period = {}
    for key, tag in (("full", "18d"), ("fit", "18e")):
        runs = [r[key] for r in ranks]
        t = runs[0]
        cfg_k = configs.get_config(TRAIN_ARCH) if key == "full" else _mesh_cut(MLA_ARCH, periods)
        n_attn = cfg_k.n_periods * (cfg_k.period.count("attn") + cfg_k.period.count("mla"))
        steps = MESH_FULL_STEPS if key == "full" else MESH_FIT_STEPS
        whole_need = t["whole_step"] + t["predicted"] - t["held_bound"]
        log(f"  {tag}: {cfg_k.name} at {cfg_k.n_periods} periods, {t['per_period']} leaves "
            f"gathered a period at a time; losses {[x['losses'] for x in runs]}"
            + (f", one device {one['full']}" if key == "full" else "")
            + f"; step peak above the bytes before it, a rank {[x['peak'] for x in runs]} B, "
            f"(before the update, in it) {[x['phases'] for x in runs]} (predicted "
            f"{t['predicted']}, by phase {t['predicted_parts']}, the plan's bound on full "
            f"tensors {t['held_bound']} in the first; the whole-gather step's full tensors "
            f"{t['whole_step']}, with the rest {whole_need}); the plan's held "
            f"bytes at most {[x['held_peak'] for x in runs]} (bound {t['held_bound']}); "
            f"allocated above the level before the state {[x['allocated'] for x in runs]} "
            f"(the plan's at rest {t['at_rest']}); step seconds {[x['step_s'] for x in runs]}, "
            f"collectives {[x['collective_s'] for x in runs]}; collectives issued "
            f"{t['issued']}, the plan's a step {t['want']}; flash launches a rank "
            f"{[x['launches']['flash_attention'] for x in runs]}")
        for x in runs:
            if x["losses"] != t["losses"] or x["checksum"] != t["checksum"]:
                raise AssertionError(f"{tag}: the ranks' losses or whole leaves differ")
            if not np.isfinite(x["losses"]).all():
                raise AssertionError(f"{tag}: a loss is not finite: {x['losses']}")
            if x["launches"]["flash_attention"] != 2 * n_attn * steps:
                raise AssertionError(f"{tag}: {x['launches']['flash_attention']} flash "
                                     f"launches, expected {2 * n_attn * steps}")
            if not 0 < x["held_peak"] <= x["held_bound"] < x["whole_step"]:
                raise AssertionError(f"{tag}: the plan held {x['held_peak']} B at once, its "
                                     f"bound {x['held_bound']}, the whole step {x['whole_step']}")
            if not max(x["peak"]) <= x["predicted"]:
                raise AssertionError(f"{tag}: a step allocated {max(x['peak'])} B above its "
                                     f"start, predicted at most {x['predicted']}")
            if not max(x["peak"]) < x["whole_step"]:  # the whole-gather step's full tensors
                raise AssertionError(f"{tag}: a step allocated {max(x['peak'])} B above its "
                                     f"start, the whole-gather step's full tensors alone "
                                     f"{x['whole_step']}")
            if any(abs(a - x["at_rest"]) > AT_REST_RTOL * x["at_rest"] for a in x["allocated"]):
                raise AssertionError(f"{tag}: allocated {x['allocated']} between steps, the "
                                     f"plan holds {x['at_rest']}")
            want = {k: v * steps for k, v in x["want"].items() if k != "total"}
            if x["issued"] != want:
                raise AssertionError(f"{tag}: collectives {x['issued']}, the plan's {want}")
        if MESH_RANKS * (max(t["allocated"]) + max(t["peak"])) > card:
            raise AssertionError(f"{tag}: the ranks' bytes exceed the card")
        found_k = dict(losses=t["losses"], peak=[x["peak"] for x in runs],
                       phases=[x["phases"] for x in runs], predicted=t["predicted"],
                       predicted_parts=t["predicted_parts"], held_peak=t["held_peak"],
                       held_bound=t["held_bound"], whole_step=t["whole_step"],
                       whole_need=whole_need, at_rest=t["at_rest"], allocated=t["allocated"],
                       step_s=[x["step_s"] for x in runs],
                       collective_s=[x["collective_s"] for x in runs], issued=t["issued"],
                       periods=cfg_k.n_periods)
        if key == "full":
            gap = loss_gap(t["losses"], one["full"])
            log(f"  18d against one device: largest relative loss gap {gap:.3g} (limit "
                f"{MESH_LOSS_RTOL}); parameters |P - P1| / |P1 - P0| {t['param_gap']:.6g} "
                f"(limit {MESH_PARAM_RTOL}), the leaves furthest {t['gap_leaves']}; one "
                f"device's step seconds {one['full_step_s']}")
            if gap > MESH_LOSS_RTOL:
                raise AssertionError("18d: the two ranks' losses are off the one-device run's")
            if not t["param_gap"] <= MESH_PARAM_RTOL:
                raise AssertionError("18d: the two ranks' parameters are off the one-device "
                                     "run's")
            found_k.update(one=one["full"], gap=gap, param_gap=t["param_gap"])
        else:
            found_k.update(fit_need=fit_need, card=card)
        per_period[key] = found_k
    lr0_gap = loss_gap(one["train_lr0"], one["train"])
    log(f"  18b's control at lr 0 on one device: losses {one['train_lr0']} (gap {lr0_gap:.3g}, "
        f"limit {MESH_LOSS_RTOL})")
    if not lr0_gap > MESH_LOSS_RTOL:
        raise AssertionError(f"18b: the lr-0 control passed the loss gate ({lr0_gap})")
    out = dict(serve_gaps=gaps, serve_limit=limit, tokens_differing=differ,
               serve_prefill_s=[r["serve"]["prefill_s"] for r in ranks],
               serve_tokens_per_s=[r["serve"]["tokens_per_s"] for r in ranks],
               train=found["train"], moe=found["moe"], train_lr0_gap=lr0_gap,
               allocated=[t["allocated"] for t in tr], at_rest=tr[0]["at_rest"],
               collective_bytes=tr[0]["want"], ranks_s=ranks_s, full=per_period["full"],
               fit=per_period["fit"], seconds=time.perf_counter() - t0)
    log(f"  phase 18: {out['seconds']:.1f} s ({ranks_s:.1f} s of it the ranks, start-up "
        "included)")
    launches = {"serve": ranks[0]["serve"]["launches"], "train": ranks[0]["train"]["launches"],
                "moe": ranks[0]["moe"]["launches"], "full": ranks[0]["full"]["launches"],
                "fit": ranks[0]["fit"]["launches"]}
    return out, launches


# ---------------------------------------------------------------------------
# Phase 19: tensor parallelism (a model axis of 2) over gloo ranks on the card
# ---------------------------------------------------------------------------

TP_SERVE_ARCH = "qwen3-8b"
# 19a serves Qwen3-8B at full width cut to 12 of its 36 periods: phase 20
# shares the script's time limit, and each layer of 19a costs two gloo
# all_reduces a decode step (phase 6 serves all 36 on one device)
TP_SERVE_PERIODS = 12
TP_PROMPT, TP_GEN = 1024, 32
TP_TIMEOUT_S = 420
# 19c's fp32 witness: the same cut, steps and replayed routes in fp32, on the
# ranks and on one device.  Without bf16's roundings of each row-parallel
# partial, the two differ only by the order of fp32 sums (relative 1e-7 an
# entry), so an update can flip only where a gradient entry is that close to
# zero: the limits sit far below bf16's and far above that.  The parameter
# limit holds every leaf, so a fault in a small leaf (the router) shows.
TP_FP32_LOSS_RTOL = 1e-5
TP_FP32_PARAM_RTOL = 0.01
# 19c's controls in bf16 and in fp32 (TPControl's names)
TP_MOE_CONTROLS = {"moe": ("no_sum",), "moe32": ("aux_k", "aux_grad")}

TP_RANK_PROGRAM = """
import datetime, os, sys
import torch.distributed as dist

rank, world, work, here = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", store=dist.FileStore(os.path.join(work, f"tp_store{world}"),
                                                     world),
                        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=300))
try:
    sys.path.insert(0, here)
    import chip_smoke as C
    C.tp_rank(rank, world, work)
finally:
    dist.destroy_process_group()
"""


class TPControl:
    """A fault of the model axis patched in while entered: 19b-c's controls,
    which must fail the gates, and the CPU tests' (``tests/
    _torch_tensor_parallel_ranks.py`` imports this one definition).
    ``no_sum`` leaves out ``f``'s sum of the partial gradients; ``times_k``
    gives ``g`` a backward sum where every model rank already holds the
    whole gradient (x k upstream); ``aux_k`` sums the MoE aux loss, the same
    on every model rank, over the axis both ways (counted k times in the
    loss and in its gradient); ``aux_grad`` counts it once in the loss but
    sums its gradient over the axis (the router's aux part x k, the loss's
    value unchanged); ``mamba_g`` sums Mamba's ``xin @ w_x`` by ``g`` alone
    (its partial gradient not summed back: phase 20b's); ``r_unsummed`` leaves
    the sLSTM recurrent weights' gradient, a partial sum over the model axis,
    unsummed (phase 20a's)."""

    NAMES = ("no_sum", "times_k", "aux_k", "aux_grad", "mamba_g", "r_unsummed")

    def __init__(self, name):
        if name not in self.NAMES:
            raise ValueError(f"unknown control {name!r}")
        self.name = name

    def __enter__(self):
        from repro_torch.models import moe
        from repro_torch.runtime import tensor_parallel as tp
        from repro_torch.runtime.data_parallel import DataParallelPlan

        self._mods = (tp, moe, DataParallelPlan)
        self._saved = (tp.copy_to_model, tp.reduce_from_model, moe.aux_loss, tp.sum_over_model,
                       DataParallelPlan.sync_grad)
        aux, f, sync = moe.aux_loss, tp.copy_to_model, DataParallelPlan.sync_grad

        def two_way(t):
            ms = tp.active()
            return t if ms is None else ms.comm.all_reduce_grad(t, ms.group)

        if self.name == "no_sum":
            tp.copy_to_model = lambda t: t
        elif self.name == "times_k":
            tp.reduce_from_model = two_way
        elif self.name == "aux_k":
            moe.aux_loss = lambda *a, **kw: two_way(aux(*a, **kw))
        elif self.name == "aux_grad":
            moe.aux_loss = lambda *a, **kw: f(aux(*a, **kw))
        elif self.name == "mamba_g":  # a Jamba cut's only two-way sums are Mamba's
            tp.sum_over_model = tp.reduce_from_model
        else:
            def unsummed(plan, name, g):  # the plan's seam a leaf, in a period or after it
                if not name.endswith(".r"):
                    return sync(plan, name, g)
                leaf = plan.leaves[name]
                plan.leaves = {**plan.leaves, name: leaf._replace(partial=False)}
                try:
                    return sync(plan, name, g)
                finally:
                    plan.leaves = {**plan.leaves, name: leaf}

            DataParallelPlan.sync_grad = unsummed
        return self

    def __exit__(self, *exc):
        tp, moe, plan = self._mods
        (tp.copy_to_model, tp.reduce_from_model, moe.aux_loss, tp.sum_over_model,
         plan.sync_grad) = self._saved


def tp_rank(rank, world, work):
    """One rank of phase 19 on the one card.  A world of 2 is a (data 1,
    model 2) mesh: 19a serves Qwen3-8B and decodes fed one device's tokens,
    19b trains Qwen2-1.5B's 2-period cut (and its two controls), 19c
    DeepSeek-V2-Lite's (routes replayed, and its control), then in fp32 (and
    the aux loss's two controls); a world of 4 is (data 2, model 2): 19b's
    cut again.
    Writes what it got to ``work/tp_w<world>_rank<rank>.pt``."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.models.model import Transformer
    from repro_torch.runtime.data_parallel import DataParallelPlan

    torch.cuda.set_device(0)
    shape = (1, 2) if world == 2 else (2, 2)
    mesh = init_device_mesh("cuda", shape, mesh_dim_names=("data", "model"))
    # cuBLAS allocates a 32 MiB workspace for each thread's first product (the
    # step's forward here, its backward on autograd's device thread): make
    # both before any at-rest reading, which holds the plan's bytes only
    w = torch.ones((64, 64), dtype=torch.bfloat16, device="cuda", requires_grad=True)
    torch.autograd.grad((w @ w).sum(), w)
    del w
    out = {}
    cut = _mesh_cut(TRAIN_ARCH, MESH_TRAIN_PERIODS)
    one = torch.load(os.path.join(work, "one_train.pt"), mmap=True)
    if world == 2:  # every rank holds every row
        # 19a: serve Qwen3-8B at full width cut to TP_SERVE_PERIODS, every rank all 4 rows
        cfg = _mesh_cut(TP_SERVE_ARCH, TP_SERVE_PERIODS)
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        served = serve(cfg, batch=TRAIN_BATCH, prompt_len=TP_PROMPT, gen_tokens=TP_GEN, seed=0,
                       mesh=mesh)
        serve_s = time.perf_counter() - t0
        launches = ops.launch_counts()
        logits = served.pop("prefill_logits").float().cpu()
        torch.cuda.empty_cache()
        # what a rank holds of the weights: the model from the seed, cut
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        model = Transformer(cfg, device="cuda", seed=0)
        plan = DataParallelPlan(cfg, model, mesh)
        plan.gather_params(model, plan.shard_params(model))
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - base
        # the same cut weights' decode fed one device's served tokens
        forced = _forced_logits(model, _tp_prompts(cfg, "cuda"),
                                np.load(os.path.join(work, "tp_generated.npy")), plan)
        del model, plan
        torch.cuda.empty_cache()
        out["serve"] = dict(logits=logits, generated=served["generated"],
                            prefill_s=served["prefill_s"], decode_s=served["decode_s"],
                            tokens_per_s=served["tokens_per_s"], serve_s=serve_s,
                            launches=launches, held=held, at_rest=served["at_rest_bytes"],
                            forced=forced)
        # 19b on (1, 2), then its two controls
        out["train"] = _rank_train(cut, mesh, MESH_STEPS, one)
        for control in ("no_sum", "times_k"):
            out[f"train_{control}"] = _rank_train(cut, mesh, MESH_STEPS, one, control=control)
        # 19c, each rank replaying every route call's ids, and its control; then
        # the cut in fp32 with the aux loss's two controls
        moe_cut = _mesh_cut(MLA_ARCH, 2)
        for key, cfg_c in (("moe", moe_cut), ("moe32", _fp32(moe_cut))):
            one_c = torch.load(os.path.join(work, f"one_{key}.pt"), mmap=True)
            ids = torch.load(os.path.join(work, f"{key}_ids.pt"), map_location="cuda")
            out[key] = _rank_train(cfg_c, mesh, MESH_MOE_STEPS, one_c, replay=ids)
            for control in TP_MOE_CONTROLS[key]:
                out[f"{key}_{control}"] = _rank_train(cfg_c, mesh, MESH_MOE_STEPS, one_c,
                                                      replay=ids, control=control)
    else:
        out["train"] = _rank_train(cut, mesh, MESH_STEPS, one)
    torch.save(out, os.path.join(work, f"tp_w{world}_rank{rank}.pt"))


def _fp32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def _tp_prompts(cfg, dev):
    """19a's and 20a-b's prompts, serve's draw from seed 0."""
    import torch

    return torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TP_PROMPT)), device=dev)


def _forced_logits(model, prompts, forced, plan=None, use_kernel=None):
    """Decode fed ``forced``'s tokens (B, n), each step's instead of its own
    choice (teacher forcing), after a prefill of ``prompts`` as ``serve``'s:
    the prefill's and each decode step's last-token logits, (n, B, V) fp32
    on the host, gathered over the model axis under ``plan``."""
    import torch

    B, P = prompts.shape
    n = forced.shape[1]
    tokens = torch.as_tensor(forced, device=prompts.device)
    gather = (lambda t: t) if plan is None else plan.gather_vocab
    with torch.inference_mode(), (contextlib.nullcontext() if plan is None else plan.scope()):
        logits, cache = model.prefill(prompts, P + n, use_kernel)
        out = [gather(logits[:, -1]).float().cpu()]
        for i in range(n - 1):
            pos = torch.full((B,), P + i, dtype=torch.long, device=prompts.device)
            logits, cache = model.decode_step(cache, tokens[:, i], pos)
            out.append(gather(logits[:, 0]).float().cpu())
    return torch.stack(out)


def tp_one_device(dev, work):
    """19a's and 19c's one-device runs: Qwen3-8B's served tokens (to
    ``work/tp_generated.npy``, which the ranks' decode is fed) and the same
    weights' logits at the prefill and at each decode step fed those tokens,
    through the kernel (bf16) and an fp32 copy; 19c's cut in fp32, its
    parameters and route ids to ``work`` as phase 18 leaves the bf16 cut's."""
    import torch

    from repro_torch.launch.serve import serve
    from repro_torch.models.model import Transformer

    cfg = _mesh_cut(TP_SERVE_ARCH, TP_SERVE_PERIODS)
    served = serve(cfg, batch=TRAIN_BATCH, prompt_len=TP_PROMPT, gen_tokens=TP_GEN, seed=0)
    np.save(os.path.join(work, "tp_generated.npy"), served["generated"])
    model = Transformer(cfg, device=dev, seed=0)
    prompts = _tp_prompts(cfg, dev)
    forced = _forced_logits(model, prompts, served["generated"])
    model32 = Transformer.from_params(_fp32(cfg), model.state_dict(), device=dev)
    del model
    forced32 = _forced_logits(model32, prompts, served["generated"], use_kernel=False)
    del model32
    one = dict(generated=served["generated"], prefill_s=served["prefill_s"],
               decode_s=served["decode_s"], tokens_per_s=served["tokens_per_s"],
               forced=forced, forced32=forced32)
    del served
    torch.cuda.empty_cache()
    with MoEProbe() as probe:
        one["moe32"] = _one_device_train(_fp32(_mesh_cut(MLA_ARCH, 2)), MESH_LR,
                                         MESH_MOE_STEPS, dev, work, "moe32")[0]
    torch.save(probe.ids, os.path.join(work, "moe32_ids.pt"))
    return one


def _tp_train_gates(tag, runs, one_losses, steps, n_flash, controls, loss_rtol=MESH_LOSS_RTOL,
                    param_rtol=MESH_PARAM_RTOL, leaf_rtol=None):
    """18b-c's gates on a (data, model) world's runs of one cut: every rank's
    losses and the leaves they hold whole bit-equal; losses within ``loss_rtol`` of
    one device's, parameters within ``param_rtol`` (and, with ``leaf_rtol``,
    each leaf's within that); the flash launches, the collectives (the
    plan's, model axis included) and the bytes held between steps; each
    control off a gate."""
    def rel(losses):
        return float(np.max(np.abs(np.subtract(losses, one_losses)) / np.abs(one_losses)))

    def passes(t):
        return (rel(t["losses"]) <= loss_rtol and t["param_gap"] <= param_rtol
                and (leaf_rtol is None or t["leaf_gap"][0] <= leaf_rtol))

    gap = rel(runs[0]["losses"])
    log(f"  {tag}: losses {[t['losses'] for t in runs]}, one device {list(one_losses)} "
        f"(largest relative gap {gap:.3g}, limit {loss_rtol}); parameters "
        f"|P - P1| / |P1 - P0| {runs[0]['param_gap']:.6g} (limit {param_rtol}; the "
        f"leaves adding most to it, with their shares: {runs[0]['gap_leaves']}; the largest "
        f"of one leaf {runs[0]['leaf_gap'][0]:.6g}, {runs[0]['leaf_gap'][1]}, limit "
        f"{leaf_rtol}); step seconds a rank {[[round(x, 4) for x in t['step_s']] for t in runs]}"
        f", of which collectives (gloo through the host) "
        f"{[[round(x, 4) for x in t['collective_s']] for t in runs]}; bytes allocated above the "
        f"level before the state, before and between steps {[t['allocated'] for t in runs]}, "
        f"the plan's at-rest {runs[0]['at_rest']}; collectives issued {runs[0]['issued']}, the "
        f"plan's a step {runs[0]['want']}; flash launches a rank "
        f"{[t['launches']['flash_attention'] for t in runs]}")
    for t in runs:
        if t["losses"] != runs[0]["losses"] or t["checksum"] != runs[0]["checksum"]:
            raise AssertionError(f"{tag}: the ranks' losses or whole leaves differ")
        if t["launches"]["flash_attention"] != n_flash:
            raise AssertionError(f"{tag}: {t['launches']['flash_attention']} flash launches, "
                                 f"expected {n_flash}")
        want = {k: v * steps for k, v in t["want"].items() if k != "total"}
        if t["issued"] != want:
            raise AssertionError(f"{tag}: collectives {t['issued']}, the plan's {want}")
        if any(abs(a - t["at_rest"]) > AT_REST_RTOL * t["at_rest"] for a in t["allocated"]):
            raise AssertionError(f"{tag}: allocated {t['allocated']} between steps, the plan "
                                 f"holds {t['at_rest']}")
    if not np.isfinite(runs[0]["losses"]).all() or not passes(runs[0]):
        raise AssertionError(f"{tag}: the losses or the parameters are off the one-device "
                             "run's")
    found = dict(losses=runs[0]["losses"], gap=gap, param_gap=runs[0]["param_gap"],
                 leaf_gap=runs[0]["leaf_gap"], step_s=[t["step_s"] for t in runs],
                 collective_s=[t["collective_s"] for t in runs], issued=runs[0]["issued"],
                 at_rest=runs[0]["at_rest"], allocated=[t["allocated"] for t in runs])
    for name, ctrl in controls.items():
        log(f"  {tag}'s control {name}: losses {ctrl['losses']} (gap {rel(ctrl['losses']):.3g})"
            f", parameters {ctrl['param_gap']:.6g}, the largest of one leaf "
            f"{ctrl['leaf_gap'][0]:.6g} ({ctrl['leaf_gap'][1]})")
        if passes(ctrl):
            raise AssertionError(f"{tag}: the control {name} passed the gates")
        found[f"control_{name}"] = dict(gap=rel(ctrl["losses"]), param_gap=ctrl["param_gap"],
                                        leaf_gap=ctrl["leaf_gap"])
    return found


def main_path_tp(dev, work):
    """Phase 19: tensor parallelism over gloo ranks on the one card, held
    against one-device runs (19a's and 19c's fp32 in this process, 19b-c's
    phase 18's, whose parameters, losses and route ids are in ``work``)."""
    import torch

    from repro_torch import configs

    t0 = time.perf_counter()
    cfg = _mesh_cut(TP_SERVE_ARCH, TP_SERVE_PERIODS)
    log(f"phase 19: tensor parallelism, gloo ranks on the one card: (a) serve {cfg.name} at "
        f"full width cut to {cfg.n_periods} layers on (data 1, model 2), batch {TRAIN_BATCH} x "
        f"{TP_PROMPT} prompt "
        f"tokens, {TP_GEN} generated, {cfg.n_heads // 2}/{cfg.n_kv_heads // 2} heads a rank, "
        f"and its decode fed one device's tokens; (b) {TRAIN_ARCH} cut to "
        f"{MESH_TRAIN_PERIODS} periods, {MESH_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} on "
        f"(1, 2) and (2, 2), two controls; (c) {MLA_ARCH} cut to 2 periods, {MESH_MOE_STEPS} "
        f"steps on (1, 2), routes replayed, one control; in fp32, two controls of the aux loss")
    torch.cuda.empty_cache()
    one = tp_one_device(dev, work)
    t1 = time.perf_counter()
    run_ranks("19", TP_RANK_PROGRAM, 2, work, TP_TIMEOUT_S)
    t2 = time.perf_counter()
    run_ranks("19", TP_RANK_PROGRAM, 4, work, TP_TIMEOUT_S)
    ranks_s = [t2 - t1, time.perf_counter() - t2]
    two = [torch.load(os.path.join(work, f"tp_w2_rank{r}.pt"), weights_only=False)
           for r in range(2)]
    four = [torch.load(os.path.join(work, f"tp_w4_rank{r}.pt"), weights_only=False)
            for r in range(4)]

    # 19a: the prefill's logits, then every decode step's fed one device's tokens
    n_attn = cfg.n_periods * cfg.period.count("attn")
    limit = LM_FACTOR * float((one["forced"][0] - one["forced32"][0]).abs().max())
    dec_limit = LM_FACTOR * float((one["forced"] - one["forced32"]).abs().max())
    sv = [r["serve"] for r in two]
    gaps = [float((r["logits"] - one["forced32"][0]).abs().max()) for r in sv]
    vs_one = [float((r["logits"] - one["forced"][0]).abs().max()) for r in sv]
    dec_gaps = [float((r["forced"] - one["forced32"]).abs().max()) for r in sv]
    step_gaps = (sv[0]["forced"] - one["forced32"]).abs().amax(dim=(1, 2))
    one_steps = (one["forced"] - one["forced32"]).abs().amax(dim=(1, 2))
    diff = sv[0]["generated"] != one["generated"]
    first_off = [int(np.argmax(row)) if row.any() else None for row in diff]

    def picks_off(logits):  # argmax under forcing against one device's served token
        return int(np.sum(logits.argmax(-1).T.numpy() != one["generated"]))

    log(f"  19a: gathered prefill last-token logits against the fp32 copy: max |gap| "
        f"{[round(g, 6) for g in gaps]} (limit {LM_FACTOR} x the one-device bf16 vs fp32 gap = "
        f"{limit:.6g}), against the one-device bf16 run {[round(g, 6) for g in vs_one]}; "
        f"decode fed one device's tokens, {TP_GEN} steps with the prefill: max |gap| from the "
        f"fp32 copy {[round(g, 6) for g in dec_gaps]} (limit {LM_FACTOR} x the one-device bf16 "
        f"gap over the steps = {dec_limit:.6g}), a step's {float(step_gaps.min()):.6g}-"
        f"{float(step_gaps.max()):.6g} (one device's {float(one_steps.min()):.6g}-"
        f"{float(one_steps.max()):.6g}); its argmax off one device's token at "
        f"{picks_off(sv[0]['forced'])} of {one['generated'].size} steps (the fp32 copy's "
        f"{picks_off(one['forced32'])}, one device's bf16 {picks_off(one['forced'])}); "
        f"generated tokens differing from one device's: {int(diff.sum())} of "
        f"{one['generated'].size}, first at step {first_off} of each row; prefill s a rank "
        f"{[round(r['prefill_s'], 4) for r in sv]} (one device {one['prefill_s']:.4f}), decode "
        f"tokens/s {[round(r['tokens_per_s'], 2) for r in sv]} (one device "
        f"{one['tokens_per_s']:.2f}); flash launches a rank "
        f"{[r['launches']['flash_attention'] for r in sv]} at ({TRAIN_BATCH * cfg.n_heads // 2}, "
        f"{TP_PROMPT}, {cfg.d_head}), group {cfg.n_heads // cfg.n_kv_heads}; weight bytes a "
        f"rank holds {[r['held'] for r in sv]}, the plan's at-rest {sv[0]['at_rest']}")
    for rank, r in enumerate(sv):
        if r["logits"].shape != (TRAIN_BATCH, cfg.vocab_size) or not bool(
                torch.isfinite(r["logits"]).all()):
            raise AssertionError(f"19a: rank {rank}'s gathered logits are "
                                 f"{tuple(r['logits'].shape)} or not finite")
        if r["forced"].shape != one["forced32"].shape or not torch.equal(r["forced"],
                                                                         sv[0]["forced"]):
            raise AssertionError(f"19a: rank {rank}'s decode logits are "
                                 f"{tuple(r['forced'].shape)} or not the other rank's")
        if r["launches"]["flash_attention"] != n_attn:
            raise AssertionError(f"19a: rank {rank} launched flash "
                                 f"{r['launches']['flash_attention']} times, expected {n_attn}")
        if r["generated"].shape != (TRAIN_BATCH, TP_GEN) or not np.array_equal(
                r["generated"], sv[0]["generated"]):
            raise AssertionError("19a: the ranks' tokens differ or are not the whole batch's")
        if abs(r["held"] - r["at_rest"]) > AT_REST_RTOL * r["at_rest"]:
            raise AssertionError(f"19a: rank {rank} holds {r['held']} bytes of weights, the "
                                 f"plan {r['at_rest']}")
    if max(gaps) > limit:
        raise AssertionError("19a: the gathered logits are off the fp32 copy's")
    if not max(dec_gaps) <= dec_limit:
        raise AssertionError("19a: the decode's gathered logits are off the fp32 copy's")

    # 19b-c
    n_flash = 2 * MESH_TRAIN_PERIODS * configs.get_config(TRAIN_ARCH).period.count("attn")
    n_mla = 2 * 2 * configs.get_config(MLA_ARCH).period.count("mla")
    with np.load(os.path.join(work, "one_losses.npz")) as f:
        one_losses = {k: f[k] for k in f.files}
    found = {
        "1x2": _tp_train_gates("19b (1, 2)", [r["train"] for r in two], one_losses["train"],
                               MESH_STEPS, n_flash * MESH_STEPS,
                               {c: two[0][f"train_{c}"] for c in ("no_sum", "times_k")}),
        "2x2": _tp_train_gates("19b (2, 2)", [r["train"] for r in four], one_losses["train"],
                               MESH_STEPS, n_flash * MESH_STEPS, {}),
        "moe": _tp_train_gates("19c (1, 2)", [r["moe"] for r in two], one_losses["moe"],
                               MESH_MOE_STEPS, n_mla * MESH_MOE_STEPS,
                               {c: two[0][f"moe_{c}"] for c in TP_MOE_CONTROLS["moe"]}),
        "moe32": _tp_train_gates("19c fp32 (1, 2)", [r["moe32"] for r in two], one["moe32"],
                                 MESH_MOE_STEPS, n_mla * MESH_MOE_STEPS,
                                 {c: two[0][f"moe32_{c}"] for c in TP_MOE_CONTROLS["moe32"]},
                                 TP_FP32_LOSS_RTOL, TP_FP32_PARAM_RTOL, TP_FP32_PARAM_RTOL),
    }
    out = dict(serve_gaps=gaps, serve_limit=limit, serve_vs_one=vs_one,
               decode_gaps=dec_gaps, decode_limit=dec_limit, tokens_differing=int(diff.sum()),
               serve_prefill_s=[r["prefill_s"] for r in sv],
               serve_tokens_per_s=[r["tokens_per_s"] for r in sv],
               serve_held=[r["held"] for r in sv], serve_at_rest=sv[0]["at_rest"],
               train=found, ranks_s=ranks_s, seconds=time.perf_counter() - t0)
    log(f"  phase 19: {out['seconds']:.1f} s ({ranks_s[0]:.1f} + {ranks_s[1]:.1f} s of it the "
        "two worlds, start-up included)")
    launches = {"serve": sv[0]["launches"], "train": two[0]["train"]["launches"],
                "train_2x2": four[0]["train"]["launches"], "moe": two[0]["moe"]["launches"]}
    return out, launches



# ---------------------------------------------------------------------------
# Phase 20: tensor parallelism for the SSM mixers, the frames frontend and
# 8-bit moments (a model axis of 2) over gloo ranks on the card
# ---------------------------------------------------------------------------

TP20_GEN = 16  # 20a-b: tokens generated after the 4 x 1,024 prompts
# 20a serves xLSTM-1.3B at full width cut to 3 of its 6 periods (phase 16a
# serves all 6 on one device): the script's time limit
TP20_XLSTM_SERVE_PERIODS = 3
TP20_SSM_STEPS, TP20_JAMBA_ROWS, TP20_AUDIO_STEPS, TP20_INT8_STEPS = 2, 2, 3, 3
# 20a trains 4 x 256 tokens: the sLSTM's time loop, a Python step a token
# (~28 launches, forward, remat recompute and backward), is most of an
# xLSTM step (5-10 s a step at 1,024, PR 28 call 2)
TP20_XLSTM_SEQ = 256
# 20b: Jamba-1.5-Large's period cut to entries 0-1 and 8-9 of _period(): one
# Mamba layer and the attention layer, both with their dense MLP (2.9 B
# parameters; phase 19c covers the MoE on a model axis)
TP20_JAMBA_PERIOD = (0, 1, 8, 9)
TP20_TIMEOUT_S = 480
# the controls, each run in fp32 beside its sound fp32 run and judged by
# the fp32 witness's gates (19c's): the bf16 gates read the whole model's
# parameters, which the r leaf (4.2 M of 0.5 B entries) cannot move
TP20_CONTROLS = {"xlstm32": ("r_unsummed",), "jamba32": ("mamba_g",)}
# 20b's fp32 witness trains 1 x 512 tokens: its Mamba scan's saved chunks
# (8 log-step passes of (B, 256, 16384, 16) fp32 a chunk, ~35 GB at 2 x
# 1,024) sit beside its fp32 weights, moments and gradients (46 GB); one
# device peaked at 73.4 GB at 1 x 1,024 (PR 28 call 2)
TP20_JAMBA32_BATCH = dict(batch=1, seq=512)

TP20_RANK_PROGRAM = """
import datetime, os, sys
import torch.distributed as dist

rank, world, work, here = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", store=dist.FileStore(os.path.join(work, f"tp20_store{world}"),
                                                     world),
                        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=300))
try:
    sys.path.insert(0, here)
    import chip_smoke as C
    C.ssm_tp_rank(rank, world, work)
finally:
    dist.destroy_process_group()
"""


def _tp20_configs():
    """20a-d's configs: xLSTM-1.3B cut to 3 and to 1 period, the Jamba cut,
    HuBERT at 4 periods, Qwen2-1.5B at 2 periods."""
    from repro_torch import configs

    xlstm = configs.get_config(SSM_ARCH)
    jamba = configs.get_config(JAMBA_ARCH)
    jamba = dataclasses.replace(jamba, n_periods=1,
                                period=tuple(jamba.period[i] for i in TP20_JAMBA_PERIOD))
    return dict(xlstm=dataclasses.replace(xlstm, n_periods=TP20_XLSTM_SERVE_PERIODS),
                xlstm_cut=dataclasses.replace(xlstm, n_periods=1), jamba=jamba,
                hubert=_mesh_cut(AUDIO_ARCH, AUDIO_TRAIN_PERIODS),
                int8=_mesh_cut(TRAIN_ARCH, MESH_TRAIN_PERIODS))


def _frames_batch(cfg, step):
    """20c's batch at ``step``: 4 x 1,500 frames of ``frame_embeddings(seed=0,
    step)`` and labels drawn from ``step``, every row (a data axis of 1)."""
    import torch

    from repro_torch.data import lm as lm_data

    frames = lm_data.frame_embeddings(cfg.d_model, AUDIO_FRAMES, TRAIN_BATCH, seed=0,
                                      step=step, device="cuda")
    labels = np.random.default_rng(step).integers(0, cfg.vocab_size, (TRAIN_BATCH, AUDIO_FRAMES))
    return {"frames": frames, "labels": torch.as_tensor(labels, device="cuda")}


def _tp20_runs(cfgs):
    """20a-d's training runs, ``key -> (config, steps, _rank_train keywords)``:
    each in bf16, and 20a-c in fp32 too (20b's at ``TP20_JAMBA32_BATCH``)."""
    frames = dict(seq=AUDIO_FRAMES, batch_fn=lambda i: _frames_batch(cfgs["hubert"], i))
    runs = {"xlstm": (cfgs["xlstm_cut"], TP20_SSM_STEPS, dict(seq=TP20_XLSTM_SEQ)),
            "jamba": (cfgs["jamba"], TP20_SSM_STEPS, dict(batch=TP20_JAMBA_ROWS)),
            "hubert": (cfgs["hubert"], TP20_AUDIO_STEPS, frames),
            "int8": (cfgs["int8"], TP20_INT8_STEPS, dict(quantize=True))}
    for key in ("xlstm", "jamba", "hubert"):
        cfg, steps, kw = runs[key]
        runs[key + "32"] = (_fp32(cfg), steps, TP20_JAMBA32_BATCH if key == "jamba" else kw)
    return runs


def _serve_witness(cfg, dev, work, key):
    """20a-b's one-device serve (its tokens to ``work/<key>_generated.npy``,
    which the ranks' decode is fed) and the same weights' logits at the
    prefill and at each decode step fed those tokens, in bf16 and through an
    fp32 copy."""
    import torch

    from repro_torch.launch.serve import serve
    from repro_torch.models.model import Transformer

    served = serve(cfg, batch=TRAIN_BATCH, prompt_len=TP_PROMPT, gen_tokens=TP20_GEN, seed=0)
    np.save(os.path.join(work, f"{key}_generated.npy"), served["generated"])
    model = Transformer(cfg, device=dev, seed=0)
    prompts = _tp_prompts(cfg, dev)
    forced = _forced_logits(model, prompts, served["generated"])
    model32 = Transformer.from_params(_fp32(cfg), model.state_dict(), device=dev)
    del model
    forced32 = _forced_logits(model32, prompts, served["generated"], use_kernel=False)
    del model32
    torch.cuda.empty_cache()
    return dict(generated=served["generated"], prefill_s=served["prefill_s"],
                tokens_per_s=served["tokens_per_s"], forced=forced, forced32=forced32)


def ssm_tp_one_device(dev, work):
    """20a-d's one-device runs: 20a-b's serve witnesses, and every training
    run of :func:`_tp20_runs` (parameters to ``work`` for the ranks' gaps);
    returns the witnesses and the losses."""
    import torch

    cfgs = _tp20_configs()
    one = {key: _serve_witness(cfgs[key], dev, work, key) for key in ("xlstm", "jamba")}
    losses = {}
    for key, (cfg, steps, kw) in _tp20_runs(cfgs).items():
        torch.cuda.reset_peak_memory_stats()
        losses[key], step_s = _one_device_train(cfg, MESH_LR, steps, dev, work, key, **kw)
        log(f"  20, one device, {key}: losses {losses[key]}, step s "
            f"{[round(t, 4) for t in step_s]}, peak memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        torch.cuda.empty_cache()
    one["xlstm_floor"] = _bf16_floor(cfgs["xlstm_cut"], TP20_SSM_STEPS, dev, work, "xlstm",
                                     losses["xlstm"], seq=TP20_XLSTM_SEQ)
    return one, losses


def _bf16_floor(cfg, steps, dev, work, key, bf16_losses, **kw):
    """How far bf16 alone moves a one-device run of ``cfg``: the same steps
    in fp32 from the bf16 run's own initial weights (P0 shared), against the
    bf16 run (``work/one_<key>.pt``): the largest relative loss gap and
    ``|P32 - P1| / |P1 - P0|``."""
    import torch

    from repro_torch.models.model import Transformer

    init = Transformer(cfg, device=dev, seed=0).state_dict()
    losses32, _ = _one_device_train(_fp32(cfg), MESH_LR, steps, dev, work, key + "_floor",
                                    params=init, **kw)
    del init
    one = torch.load(os.path.join(work, f"one_{key}.pt"))
    p32 = torch.load(os.path.join(work, f"one_{key}_floor.pt"))["p1"]
    parts = {k: float(torch.sum(torch.square(p32[k].to(dev) - p1.to(dev, torch.float32))))
             for k, p1 in one["p1"].items()}
    floor = dict(loss=float(np.max(np.abs(np.subtract(losses32, bf16_losses))
                                   / np.abs(bf16_losses))),
                 params=_param_gap(parts, one), losses32=losses32)
    log(f"  20, one device, {key}'s bf16 noise floor: fp32 from the bf16 initial weights, "
        f"losses {losses32} (largest relative gap from bf16 {floor['loss']:.3g}); parameters "
        f"|P32 - P1| / |P1 - P0| {floor['params']:.6g}")
    del one, p32
    torch.cuda.empty_cache()
    return floor


def _rank_serve(cfg, mesh, work, key):
    """A rank's 20a-b: ``serve`` on the mesh (its gathered prefill logits,
    tokens, launches), then the cut weights it holds (bytes, against the
    plan), its recurrent state's shapes and dtypes, and its decode fed one
    device's tokens (the gathered logits)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.models.model import Transformer
    from repro_torch.runtime.data_parallel import DataParallelPlan

    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    served = serve(cfg, batch=TRAIN_BATCH, prompt_len=TP_PROMPT, gen_tokens=TP20_GEN, seed=0,
                   mesh=mesh)
    serve_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    logits = served.pop("prefill_logits").float().cpu()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    model = Transformer(cfg, device="cuda", seed=0)
    plan = DataParallelPlan(cfg, model, mesh)
    plan.gather_params(model, plan.shard_params(model))
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    with plan.scope():
        state = [None if c is None else [(tuple(t.shape), str(t.dtype)) for t in c]
                 for c in model.init_cache(TRAIN_BATCH, TP_PROMPT + TP20_GEN)]
    forced = _forced_logits(model, _tp_prompts(cfg, "cuda"),
                            np.load(os.path.join(work, f"{key}_generated.npy")), plan)
    del model, plan
    torch.cuda.empty_cache()
    return dict(logits=logits, generated=served["generated"], prefill_s=served["prefill_s"],
                tokens_per_s=served["tokens_per_s"], serve_s=serve_s, launches=launches,
                held=held, at_rest=served["at_rest_bytes"], state=state, forced=forced)


def ssm_tp_rank(rank, world, work):
    """One rank of phase 20 on the one card, a (data 1, model 2) mesh: 20a-b
    serve, then every training run of :func:`_tp20_runs` and the fp32
    controls.  Writes what it got to ``work/tp20_rank<rank>.pt``."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    torch.cuda.set_device(0)
    mesh = init_device_mesh("cuda", (1, world), mesh_dim_names=("data", "model"))
    # the cuBLAS workspaces of both threads before any at-rest reading (19's)
    w = torch.ones((64, 64), dtype=torch.bfloat16, device="cuda", requires_grad=True)
    torch.autograd.grad((w @ w).sum(), w)
    del w
    cfgs = _tp20_configs()
    out, seconds = {}, {}

    def timed_case(name, fn):
        t0 = time.perf_counter()
        out[name] = fn()
        seconds[name] = round(time.perf_counter() - t0, 2)

    for key in ("xlstm", "jamba"):
        timed_case(f"{key}_serve", lambda: _rank_serve(cfgs[key], mesh, work, key))
    for key, (cfg, steps, kw) in _tp20_runs(cfgs).items():
        one = torch.load(os.path.join(work, f"one_{key}.pt"), mmap=True)
        timed_case(key, lambda: _rank_train(cfg, mesh, steps, one, **kw))
        for control in TP20_CONTROLS.get(key, ()):
            timed_case(f"{key}_{control}",
                       lambda: _rank_train(cfg, mesh, steps, one, control=control, **kw))
        del one
    out["seconds"] = seconds
    torch.save(out, os.path.join(work, f"tp20_rank{rank}.pt"))


def _tp20_serve_gates(tag, cfg, sv, one, n_flash):
    """20a-b's serving gates: every rank's gathered prefill and teacher-forced
    decode logits within LM_FACTOR of one device's bf16 distance from its
    fp32 copy (19a's rule) and equal across ranks, the whole batch's tokens,
    the flash launches, the weight bytes a rank holds against the plan, and
    its recurrent state: each tensor one device's with its channels or heads
    halved (m in fp32)."""
    import torch

    from repro_torch.models import model as M

    limit = LM_FACTOR * float((one["forced"][0] - one["forced32"][0]).abs().max())
    dec_limit = LM_FACTOR * float((one["forced"] - one["forced32"]).abs().max())
    gaps = [float((r["logits"] - one["forced32"][0]).abs().max()) for r in sv]
    dec_gaps = [float((r["forced"] - one["forced32"]).abs().max()) for r in sv]
    diff = sv[0]["generated"] != one["generated"]
    whole = [None if c is None else [(tuple(t.shape), str(t.dtype)) for t in c]
             for c in M.abstract_cache(cfg, TRAIN_BATCH, TP_PROMPT + TP20_GEN)]
    log(f"  {tag}: gathered prefill last-token logits against the fp32 copy: max |gap| "
        f"{[round(g, 6) for g in gaps]} (limit {LM_FACTOR} x the one-device bf16 gap = "
        f"{limit:.6g}); decode fed one device's tokens, {TP20_GEN} steps with the prefill: "
        f"{[round(g, 6) for g in dec_gaps]} (limit {dec_limit:.6g}); generated tokens "
        f"differing from one device's: {int(diff.sum())} of {one['generated'].size}; prefill s "
        f"a rank {[round(r['prefill_s'], 4) for r in sv]} (one device "
        f"{one['prefill_s']:.4f}), decode tokens/s {[round(r['tokens_per_s'], 2) for r in sv]} "
        f"(one device {one['tokens_per_s']:.2f}); flash launches a rank "
        f"{[r['launches']['flash_attention'] for r in sv]}; weight bytes a rank holds "
        f"{[r['held'] for r in sv]}, the plan's at-rest {sv[0]['at_rest']}; a rank's state "
        f"{[s for s in sv[0]['state'] if s][:3]} ... (one device's {[s for s in whole if s][:3]})")
    for rank, r in enumerate(sv):
        if r["logits"].shape != (TRAIN_BATCH, cfg.vocab_size) or not bool(
                torch.isfinite(r["logits"]).all()):
            raise AssertionError(f"{tag}: rank {rank}'s gathered logits are "
                                 f"{tuple(r['logits'].shape)} or not finite")
        if r["forced"].shape != one["forced32"].shape or not bool(
                (r["forced"] == sv[0]["forced"]).all()):
            raise AssertionError(f"{tag}: rank {rank}'s decode logits are not the other rank's")
        if r["generated"].shape != (TRAIN_BATCH, TP20_GEN) or not np.array_equal(
                r["generated"], sv[0]["generated"]):
            raise AssertionError(f"{tag}: the ranks' tokens differ or are not the whole batch's")
        if r["launches"]["flash_attention"] != n_flash:
            raise AssertionError(f"{tag}: rank {rank} launched flash "
                                 f"{r['launches']['flash_attention']} times, expected {n_flash}")
        if abs(r["held"] - r["at_rest"]) > AT_REST_RTOL * r["at_rest"]:
            raise AssertionError(f"{tag}: rank {rank} holds {r['held']} bytes of weights, the "
                                 f"plan {r['at_rest']}")
        for got, want in zip(r["state"], whole):
            if (got is None) != (want is None):
                raise AssertionError(f"{tag}: rank {rank}'s state {got}, one device's {want}")
            for (gs, gd), (ws, wd) in zip(got or (), want or ()):
                if gd != wd or 2 * math.prod(gs) != math.prod(ws) or len(gs) != len(ws):
                    raise AssertionError(f"{tag}: rank {rank}'s state {got}, not one device's "
                                         f"{want} with its channels or heads halved")
    if max(gaps) > limit or not max(dec_gaps) <= dec_limit:
        raise AssertionError(f"{tag}: the gathered logits are off the fp32 copy's")
    return dict(prefill_gaps=gaps, limit=limit, decode_gaps=dec_gaps, decode_limit=dec_limit,
                tokens_differing=int(diff.sum()), prefill_s=[r["prefill_s"] for r in sv],
                tokens_per_s=[r["tokens_per_s"] for r in sv], held=[r["held"] for r in sv],
                at_rest=sv[0]["at_rest"])


def main_path_ssm_tp(dev, work):
    """Phase 20: tensor parallelism for xLSTM's mLSTM and sLSTM, Jamba's
    Mamba, HuBERT's frames frontend and 8-bit moments, two gloo ranks on the
    one card against one-device runs in this process."""
    import torch

    t0 = time.perf_counter()
    cfgs = _tp20_configs()
    x, j = cfgs["xlstm"], cfgs["jamba"]
    log(f"phase 20: tensor parallelism over a (data 1, model 2) mesh of gloo ranks on the one "
        f"card: (a) serve {x.name} at full width cut to {x.n_periods} periods "
        f"({_param_count(x):,} parameters, "
        f"{x.mlstm.n_heads // 2} of {x.mlstm.n_heads} mLSTM and sLSTM heads a rank), batch "
        f"{TRAIN_BATCH} x {TP_PROMPT}, {TP20_GEN} generated, and train its 1-period cut "
        f"({_param_count(cfgs['xlstm_cut']):,} parameters) {TP20_SSM_STEPS} steps of "
        f"{TRAIN_BATCH} x {TP20_XLSTM_SEQ}; (b) {j.name} at full width cut to period entries "
        f"{TP20_JAMBA_PERIOD} of 16, {j.period} ({_param_count(j):,} parameters; Mamba "
        f"d_inner {j.mamba.d_inner // 2} a rank, {j.n_heads // 2}/{j.n_kv_heads // 2} heads a "
        f"rank), served as (a) and trained {TP20_SSM_STEPS} steps of {TP20_JAMBA_ROWS} x "
        f"{TRAIN_SEQ}; (c) {cfgs['hubert'].name} at {AUDIO_TRAIN_PERIODS} periods, "
        f"{TP20_AUDIO_STEPS} steps of {TRAIN_BATCH} x {AUDIO_FRAMES} frames, "
        f"{cfgs['hubert'].vocab_size // 2} classes a rank; (d) {TRAIN_ARCH} at "
        f"{MESH_TRAIN_PERIODS} periods with 8-bit moments, {TP20_INT8_STEPS} steps; (a-c) also "
        f"in fp32 (20b's at {TP20_JAMBA32_BATCH}), with the controls {TP20_CONTROLS}")
    torch.cuda.empty_cache()
    one, one_losses = ssm_tp_one_device(dev, work)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    run_ranks("20", TP20_RANK_PROGRAM, 2, work, TP20_TIMEOUT_S)
    ranks_s = time.perf_counter() - t1
    two = [torch.load(os.path.join(work, f"tp20_rank{r}.pt"), weights_only=False)
           for r in range(2)]
    log(f"  20: rank 0's seconds by case {two[0]['seconds']}")
    # every gate is read and logged before the first failure raises
    gates = {"xlstm_serve": lambda: _tp20_serve_gates(
                 "20a", x, [r["xlstm_serve"] for r in two], one["xlstm"], 0),
             "jamba_serve": lambda: _tp20_serve_gates(
                 "20b", j, [r["jamba_serve"] for r in two], one["jamba"], 1)}
    for key, (cfg, steps, kw) in _tp20_runs(cfgs).items():
        n_flash = 2 * cfg.n_periods * cfg.period.count("attn") * steps
        tag = {"xlstm": "20a", "jamba": "20b", "hubert": "20c",
               "int8": "20d"}[key.removesuffix("32")]
        limits = ((TP_FP32_LOSS_RTOL, TP_FP32_PARAM_RTOL, TP_FP32_PARAM_RTOL)
                  if key.endswith("32") else ())
        if key == "xlstm":
            # 20a's bf16 steps are held by LM_FACTOR times bf16's own distance,
            # in this call, from an fp32 run of the same initial weights, not
            # by 18-19's fixed limits: xLSTM's bf16 forward sits 2.3-2.6
            # logits from fp32 where Qwen3-8B's sits 0.066 (16a, 20a), and its
            # sound TP run read 1.77e-4 / 0.266 against 6e-5 / 0.1 while its
            # fp32 witness read 3.4e-7 / 0.00041 (PR 28 call 3).  The fp32
            # witness (19c's limits, every leaf) is the fine check.
            floor = one["xlstm_floor"]
            limits = (LM_FACTOR * floor["loss"], LM_FACTOR * floor["params"])
        gates[key] = functools.partial(
            _tp_train_gates, f"{tag} {'fp32 ' if key.endswith('32') else ''}train",
            [r[key] for r in two], one_losses[key], steps, n_flash,
            {c: two[0][f"{key}_{c}"] for c in TP20_CONTROLS.get(key, ())}, *limits)
    found, failed = {}, []
    for key, gate in gates.items():
        try:
            found[key] = gate()
        except AssertionError as e:
            failed.append(str(e))
    out = dict(found=found, ranks_s=ranks_s, one_s=t1 - t0, seconds=time.perf_counter() - t0)
    log(f"  phase 20: {out['seconds']:.1f} s ({t1 - t0:.1f} s the one-device runs, "
        f"{ranks_s:.1f} s the ranks, start-up included)")
    if failed:
        raise AssertionError(f"phase 20: {failed}")
    launches = {"jamba_serve": two[0]["jamba_serve"]["launches"],
                "jamba_train": two[0]["jamba"]["launches"],
                "hubert_train": two[0]["hubert"]["launches"]}
    return out, launches

def main() -> int:
    import tempfile

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
    fista = check_fista_step(dev, 1_200_000, 12, 2, steps=300, reps=200)

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
        # phase 15's other shapes: Kimi-K2's serve (GQA group 8, 15c) and
        # DeepSeek-V2-Lite's train steps (d = 192 / dv = 128 at 1024, 15d)
        "kimi_gqa8": check_flash(dev, "Kimi-K2 serve", 4, 64, 8, 2048, 2048, 128, 128, True,
                                 10),
        "mla_train": check_flash(dev, "MLA train", 4, 16, 16, 1024, 1024, 192, 128, True, 10),
        # phase 16's new shapes: Qwen2-VL's serve (GQA group 6, 16c) and
        # HuBERT's encoder (d = 80, non-causal: the wgmma variant's five
        # 16-column boxes, 16d)
        "qwen2vl_gqa6": check_flash(dev, "Qwen2-VL serve", 4, 12, 2, 2048, 2048, 128, 128,
                                    True, 10),
        "hubert_d80": check_flash(dev, "HuBERT encoder", 4, 16, 16, 1500, 1500, 80, 80, False,
                                  10),
        # the scalar variant in bf16, at a head size with no wgmma
        # instantiation (the reduced configs'; no full-size main path takes it)
        "scalar_24_16": check_flash(dev, "scalar variant", 1, 3, 3, 65, 150, 24, 16, False,
                                    10),
    }
    for key, kind in (("serve", "wgmma"), ("hubert_d80", "wgmma"), ("scalar_24_16", "scalar")):
        if flash[key]["variant"] != kind:
            raise AssertionError(f"flash shape {key} took the {flash[key]['variant']} variant, "
                                 f"not {kind}")
    p6 = {}
    serve_launches, lm = main_path_serve(dev, keep=p6)
    oracle_launches, oracle = main_path_oracles(paper_data, wide_fast)
    abm_launches, gram3, baselines = main_path_baselines(dev, paper_data, wide_fast[0])
    batch_launches, class_batched = main_path_class_batch(paper_data)
    stream_kernels, stream_launches, streamed = main_path_streaming(dev)
    serving = main_path_serving(paper_clf, paper_data, wide_fast)
    continuous, loop_launches = main_path_continuous()
    distributed, dist_launches = main_path_distributed(paper_clf, paper_data)
    training, train_launches = main_path_train(dev)
    p15 = {}
    moe_run, moe_launches = main_path_moe(dev, keep=p15)
    families, family_launches = main_path_families(dev)
    optimized = main_path_optimized(dev, p6, p15)
    with tempfile.TemporaryDirectory() as work:  # phase 18's one-device runs, for 19 too; 20's
        mesh_run, mesh_launches = main_path_mesh(dev, work)
        tp_run, tp_launches = main_path_tp(dev, work)
        ssm_tp_run, ssm_tp_launches = main_path_ssm_tp(dev, work)

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
        # launches: phase 6's serve (prefill); train_launches: phase 14a's
        # training run (each layer's forward and its remat recompute); phase
        # 15's paths: DeepSeek-V2-Lite's serve (MLA prefill at d = 192, dv =
        # 128, checked at that shape as mla_dv), Kimi-K2's one-period serve
        # (GQA 64/8, kimi_gqa8) and DeepSeek's three train steps at 2 periods
        # (mla_train); phase 16's: Jamba's block serve (GQA 64/8, Kimi-K2's
        # shape), Qwen2-VL's serve (GQA 12/2, qwen2vl_gqa6), HuBERT's forward
        # and its train steps (d = 80, non-causal, hubert_d80); the scalar
        # variant's bf16 check (scalar_24_16) has no main-path launch
        dict(name="flash_attention", route="cuda", source=src + "flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:81",
             launches=serve_launches["flash_attention"],
             train_launches=train_launches["flash_attention"],
             mla_serve_launches=moe_launches["mla_serve"]["flash_attention"],
             kimi_serve_launches=moe_launches["kimi"]["flash_attention"],
             mla_train_launches=moe_launches["mla_train"]["flash_attention"],
             mla_dv=dict(launches=moe_launches["mla_serve"]["flash_attention"],
                         **flash["mla_dv"]),
             kimi_gqa8=dict(launches=moe_launches["kimi"]["flash_attention"],
                            **flash["kimi_gqa8"]),
             mla_train=dict(launches=moe_launches["mla_train"]["flash_attention"],
                            **flash["mla_train"]),
             jamba_serve_launches=family_launches["jamba"]["flash_attention"],
             qwen2vl_gqa6=dict(launches=family_launches["vlm"]["flash_attention"],
                               **flash["qwen2vl_gqa6"]),
             hubert_d80=dict(launches=family_launches["hubert"]["flash_attention"],
                             train_launches=family_launches["hubert_train"]["flash_attention"],
                             **flash["hubert_d80"]),
             scalar_24_16=flash["scalar_24_16"],
             # phase 18, each of the two ranks (rank 0's count; both gated):
             # its rows' prefill, the dense cut's steps, the MoE cut's steps
             mesh_serve_launches=mesh_launches["serve"]["flash_attention"],
             mesh_train_launches=mesh_launches["train"]["flash_attention"],
             mesh_moe_train_launches=mesh_launches["moe"]["flash_attention"],
             # 18d-e: the per-period schedule at full width, each rank:
             # Qwen2-1.5B's 28 layers' two steps; DeepSeek-V2-Lite's cut's step
             # (d = 192 / dv = 128, as mla_train)
             mesh_full_train_launches=mesh_launches["full"]["flash_attention"],
             mesh_fit_train_launches=mesh_launches["fit"]["flash_attention"],
             # phase 19, each rank of a model axis of 2 at its local heads
             # (rank 0's count; every rank gated): Qwen3-8B's prefill at
             # (64, 1024, 128) group 4, the dense cut's steps on (1, 2) and
             # (2, 2), the MoE cut's (MLA at d = 192 / dv = 128, 8 heads)
             tp_serve_launches=tp_launches["serve"]["flash_attention"],
             tp_train_launches=tp_launches["train"]["flash_attention"],
             tp_train_2x2_launches=tp_launches["train_2x2"]["flash_attention"],
             tp_moe_train_launches=tp_launches["moe"]["flash_attention"],
             # phase 20, each rank of a model axis of 2 (rank 0's count; every
             # rank gated): Jamba's cut at 32 of 64 heads, group 8, its prefill
             # at (128, 1024, 128) and its two steps at (64, 1024, 128);
             # HuBERT's 8 of 16 heads of 80, non-causal, at (32, 1500, 80)
             tp_jamba_serve_launches=ssm_tp_launches["jamba_serve"]["flash_attention"],
             tp_jamba_train_launches=ssm_tp_launches["jamba_train"]["flash_attention"],
             tp_hubert_train_launches=ssm_tp_launches["hubert_train"]["flash_attention"],
             **flash["serve"]),
        # the SVM head of the paper-scale classifier (phase 3): one launch a
        # FISTA step
        dict(name="fista_step", route="cuda", source=src + "fista_step.cu",
             replaces="none (src/repro/core/svm.py's lax.while_loop)",
             launches=launches["fista_step"], **fista),
    ]
    for entry in kernels:
        nested = [v["launches"] for v in entry.values() if isinstance(v, dict) and "launches" in v]
        counts = [v for k, v in entry.items() if k.endswith("launches")]
        if min(counts + nested) <= 0:
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
        "training": training,
        "moe": moe_run,
        "families": families,
        "optimized": optimized,
        "mesh": mesh_run,
        "tensor_parallel": tp_run,
        "tensor_parallel_ssm": ssm_tp_run,
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
