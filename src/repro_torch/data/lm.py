"""Deterministic, checkpointable token pipeline for the LM substrate.

The port's own copy of ``src/repro/data/lm.py`` (that module imports JAX, so
nothing is imported from it).  The numpy parts are the reference's, line
for line, and give its tokens bit for bit:

* **deterministic in (seed, step)** -- batch ``t`` is a pure function of the
  pipeline state, so training is bit-reproducible across restarts and the
  pipeline state that must be checkpointed is just ``(seed, step)``;
* **shardable** -- any split of the global batch's rows reconstructs the
  same batch (each row is keyed by its global index);
* **structured** -- a degree-2 Markov chain over the vocabulary rather than
  iid noise, so cross-entropy actually decreases during training.

Where the reference places the global batch under a mesh's sharding
(``batch_for_mesh``), each process of the port holds its own rows:
:func:`batch_for_mesh` builds this rank's block of the batch with
:func:`host_batch_at`, the multi-host form the reference's docstring
describes; :func:`batch_for_device` puts the whole batch on one device.
:func:`targets_from_tokens` and :func:`frame_embeddings` return tensors.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from .. import _device
from ..core import distributed


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0


@dataclasses.dataclass
class PipelineState:
    """The whole checkpointable state of the pipeline."""

    step: int = 0

    def to_dict(self):
        return {"step": self.step}

    @classmethod
    def from_dict(cls, d):
        return cls(step=int(d["step"]))


def _fold(seed: int, *xs: int) -> np.random.Generator:
    ss = np.random.SeedSequence([seed, *[int(x) & 0x7FFFFFFF for x in xs]])
    return np.random.default_rng(ss)


@functools.lru_cache(maxsize=64)
def _grammar(cfg: PipelineConfig) -> Tuple[int, int]:
    """LCG "grammar" (a, b): a function of the pipeline seed ALONE, so the
    transition map is shared across rows and steps (learnable), while the
    trajectories (start token, noise) stay per-(seed, step, row)."""
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, 0xA11CE]))
    a = int(rng.integers(3, 64)) * 2 + 1
    b = int(rng.integers(0, cfg.vocab_size))
    return a, b


def _markov_row(cfg: PipelineConfig, seed_vec: np.ndarray) -> np.ndarray:
    """One sequence from the seed's Markov chain over a hashed alphabet."""
    V = cfg.vocab_size
    T = cfg.seq_len
    # token t+1 = (a * token_t + b + noise) mod V -- linear-congruential grammar
    a, b = _grammar(cfg)
    rng = np.random.default_rng(np.random.SeedSequence(seed_vec.tolist()))
    toks = np.empty((T,), np.int32)
    toks[0] = int(rng.integers(0, V))
    noise = rng.integers(0, 17, size=T)
    for t in range(1, T):
        toks[t] = (a * int(toks[t - 1]) + b + int(noise[t])) % V
    return toks


def global_batch_at(cfg: PipelineConfig, step: int) -> np.ndarray:
    """The full (global_batch, seq_len) int32 token batch at ``step``."""
    return host_batch_at(cfg, step, 0, cfg.global_batch)


def host_batch_at(cfg: PipelineConfig, step: int, row_start: int,
                  row_count: int) -> np.ndarray:
    """Rows [row_start, row_start+row_count) of the global batch at ``step``,
    each keyed by (seed, step, global_row)."""
    out = np.empty((row_count, cfg.seq_len), np.int32)
    for i in range(row_count):
        g = row_start + i
        seed_vec = np.array([cfg.seed, step, g], dtype=np.int64)
        out[i] = _markov_row(cfg, seed_vec)
    return out


def batch_for_device(cfg: PipelineConfig, step: int, device=None) -> torch.Tensor:
    """The global batch at ``step`` as an int64 tensor on ``device``
    (``None``: the CUDA card)."""
    dev = _device.resolve(device)
    return torch.from_numpy(global_batch_at(cfg, step)).to(device=dev, dtype=torch.long)


def batch_for_mesh(cfg: PipelineConfig, step: int, mesh, batch_axes: Tuple[str, ...] = ("data",),
                   device=None) -> torch.Tensor:
    """This rank's rows ``[i * B / w, (i + 1) * B / w)`` of the global batch
    at ``step`` as an int64 tensor on ``device`` (``None``: the CUDA card),
    ``i`` the rank's index over ``batch_axes`` of ``mesh`` (row-major) and
    ``w`` their size; a mesh of one device (or ``None``) takes every row.  A
    batch the ranks do not divide raises ``ValueError``."""
    shards, index = 1, 0
    if mesh is not None and mesh.size() > 1:
        lay = distributed.layout(mesh, batch_axes)
        shards, index = lay.shards, lay.index
    if cfg.global_batch % shards:
        raise ValueError(f"a batch of {cfg.global_batch} rows does not split over "
                         f"{shards} ranks of {batch_axes}")
    n = cfg.global_batch // shards
    rows = host_batch_at(cfg, step, index * n, n)
    return torch.from_numpy(rows).to(device=_device.resolve(device), dtype=torch.long)


def targets_from_tokens(tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Next-token prediction: inputs = tokens[:, :-1], labels = tokens[:, 1:]."""
    return tokens[:, :-1], tokens[:, 1:]


def frame_embeddings(d_model: int, seq_len: int, batch: int, seed: int = 0, step: int = 0,
                     dtype=torch.float32, device=None) -> torch.Tensor:
    """Precomputed modality-frontend output (audio frames / vision patches)
    on ``device`` (``None``: the CUDA card).  Deterministic in (seed, step);
    unit RMS per frame; the reference's values."""
    rng = _fold(seed, step, d_model, seq_len, batch)
    x = rng.standard_normal((batch, seq_len, d_model)).astype(np.float32)
    x /= np.sqrt((x * x).mean(axis=-1, keepdims=True) + 1e-6)
    return torch.from_numpy(x).to(device=_device.resolve(device), dtype=dtype)
