"""VCA: Vanishing Component Analysis (Livni et al. 2013).

Counterpart of ``src/repro/core/vca.py``, the paper's monomial-agnostic
baseline of Section 6.  Degree by degree, VCA keeps a set ``F`` of
*non-vanishing* polynomials (their evaluation vectors of unit norm) and a set
``V`` of *vanishing components* (the generators).  At degree ``d`` the
candidates are the products ``f * g`` with ``f in F_{d-1}`` and
``g in F_1``; they are projected onto the orthogonal complement of
``span F``, and an SVD of the residual splits its span into vanishing
directions (``sigma^2 / m <= psi``, the paper's MSE scale) and new
non-vanishing ones.  Evaluation on new points replays this construction.

The fit runs on its device with ``torch.linalg.svd(..., full_matrices=False)``
of the residual itself (never an eigendecomposition of ``raw^T raw``, which
would square its condition number where ``S^2 / m`` meets psi), one host
read of the singular values a degree.  It keeps the reference's working
precision: there the constant component ``1 / sqrt(m)`` is a float64 scalar,
which under NumPy 2's promotion makes every projection and SVD float64, so
they run in float64 here too; the stored model is in the config dtype, and
:meth:`VCAModel.evaluate_G` runs in it on the model's device.

Singular vectors are fixed only up to sign (and rotation inside a degenerate
singular value), which LAPACK and cuSOLVER choose differently: fits from two
libraries agree in their counts per degree, their singular values and
``|G(Z)|``, not in their raw ``combo``/``proj`` arrays.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import _device


@dataclasses.dataclass(frozen=True)
class VCAConfig:
    psi: float = 0.005
    max_degree: int = 10
    dtype: str = "float32"
    # cap on |F_d| per degree to bound candidate blow-up (the paper's VCA has
    # no cap; it triggers only on pathological data and is recorded in stats)
    max_components_per_degree: int = 512


@dataclasses.dataclass
class _DegreeBlock:
    """Replayable construction of one degree's polynomials.

    candidates = F_{d-1}(Z)[:, pair_f] * F_1(Z)[:, pair_g]       (q, K)
    raw        = candidates - F_all(Z) @ proj                    (q, K)
    polys      = raw @ combo                                     (q, r)
    of which the first ``num_vanishing`` columns are generators (V_d) and the
    rest are the normalized non-vanishing components appended to F_d.
    """

    pair_f: np.ndarray  # (K,) indices into F_{d-1}
    pair_g: np.ndarray  # (K,) indices into F_1
    proj: np.ndarray  # (|F_all_before|, K) projection coefficients
    combo: np.ndarray  # (K, r) SVD combination
    num_vanishing: int
    num_nonvanishing: int


@dataclasses.dataclass
class VCAModel:
    """A fitted VCA construction tree.  ``device`` is where
    :meth:`evaluate_G` runs."""

    n: int
    psi: float
    deg1_coeffs: np.ndarray  # (n+1, r1) polys over [1, x_1..x_n]
    deg1_num_vanishing: int
    blocks: List[_DegreeBlock]
    stats: Dict
    sqrt_m: float = 1.0  # train-time normalization of the constant component
    dtype: str = "float32"
    device: torch.device = dataclasses.field(default_factory=lambda: torch.device("cpu"))

    @property
    def num_G(self) -> int:
        k = self.deg1_num_vanishing
        return k + sum(b.num_vanishing for b in self.blocks)

    @property
    def num_F(self) -> int:
        k = (self.deg1_coeffs.shape[1] - self.deg1_num_vanishing) + 1  # + const
        return k + sum(b.num_nonvanishing for b in self.blocks)

    def evaluate_G(self, Z) -> torch.Tensor:
        """Evaluation matrix of all vanishing components over Z: (q, |G|)."""
        dt = getattr(torch, self.dtype)
        dev = self.device

        def t(a):
            return torch.as_tensor(a, device=dev)

        Z = _device.tensor(Z, dt, dev)
        ones = Z.new_ones((Z.shape[0], 1))
        deg1 = torch.cat([ones, Z], dim=1) @ t(self.deg1_coeffs)  # (q, r1)
        kv = self.deg1_num_vanishing
        V_cols = [deg1[:, :kv]]
        F_prev = deg1[:, kv:]  # F_1 (normalized on train)
        F1 = F_prev
        # the constant component is the *function* x -> 1/sqrt(m_train)
        F_all = torch.cat([ones / self.sqrt_m, F_prev], dim=1)
        for b in self.blocks:
            cand = F_prev[:, t(b.pair_f).long()] * F1[:, t(b.pair_g).long()]  # (q, K)
            raw = cand - F_all[:, : b.proj.shape[0]] @ t(b.proj)
            polys = raw @ t(b.combo)
            V_cols.append(polys[:, : b.num_vanishing])
            F_prev = polys[:, b.num_vanishing :]
            F_all = torch.cat([F_all, F_prev], dim=1)
        return torch.cat(V_cols, dim=1)

    def mse(self, Z) -> torch.Tensor:
        G = self.evaluate_G(Z)
        return torch.mean(G * G, dim=0)

    def transform(self, Z) -> np.ndarray:
        """(FT) for this model alone: ``|G(Z)|`` as (q, |G|) in model dtype."""
        return np.abs(self.evaluate_G(Z).cpu().numpy())

    def to_state_dict(self) -> Tuple[Dict[str, np.ndarray], Dict]:
        """Flat array tree + JSON-safe metadata in the JAX package's layout:
        each degree block under ``block_<i>_*`` keys."""
        arrays: Dict[str, np.ndarray] = {"deg1_coeffs": self.deg1_coeffs}
        block_meta = []
        for i, b in enumerate(self.blocks):
            arrays[f"block_{i:04d}_pair_f"] = b.pair_f
            arrays[f"block_{i:04d}_pair_g"] = b.pair_g
            arrays[f"block_{i:04d}_proj"] = b.proj
            arrays[f"block_{i:04d}_combo"] = b.combo
            block_meta.append({"num_vanishing": int(b.num_vanishing),
                               "num_nonvanishing": int(b.num_nonvanishing)})
        meta = {
            "kind": "vca",
            "n": int(self.n),
            "psi": float(self.psi),
            "dtype": str(self.dtype),
            "deg1_num_vanishing": int(self.deg1_num_vanishing),
            "sqrt_m": float(self.sqrt_m),
            "blocks": block_meta,
            "stats": self.stats,
        }
        return arrays, meta

    @classmethod
    def from_state_dict(cls, arrays: Dict[str, np.ndarray], meta: Dict,
                        device=None) -> "VCAModel":
        """Rebuild a model from :meth:`to_state_dict` output (also the JAX
        package's); ``device=None`` means the CUDA card."""
        blocks = []
        for i, bm in enumerate(meta.get("blocks") or []):
            blocks.append(
                _DegreeBlock(
                    pair_f=np.asarray(arrays[f"block_{i:04d}_pair_f"]),
                    pair_g=np.asarray(arrays[f"block_{i:04d}_pair_g"]),
                    proj=np.asarray(arrays[f"block_{i:04d}_proj"]),
                    combo=np.asarray(arrays[f"block_{i:04d}_combo"]),
                    num_vanishing=int(bm["num_vanishing"]),
                    num_nonvanishing=int(bm["num_nonvanishing"]),
                )
            )
        return cls(
            n=int(meta["n"]),
            psi=float(meta["psi"]),
            deg1_coeffs=np.asarray(arrays["deg1_coeffs"]),
            deg1_num_vanishing=int(meta["deg1_num_vanishing"]),
            blocks=blocks,
            stats=dict(meta.get("stats") or {}),
            sqrt_m=float(meta["sqrt_m"]),
            dtype=str(meta["dtype"]),
            device=_device.resolve(device),
        )

    def save(self, path: str) -> str:
        """Persist via :func:`repro_torch.api.save`."""
        from .. import api

        return api.save(self, path)


def _split(raw: torch.Tensor, m: int, psi: float, cap: int, stats: Dict):
    """SVD of ``raw``: the combination of its right singular vectors into
    vanishing directions (unit combination) first, then the non-vanishing
    ones scaled to unit-norm evaluations (at most ``cap`` of them).
    Returns ``(combo, num_vanishing, num_nonvanishing, capped)``."""
    t0 = time.perf_counter()
    _, S, Vh = torch.linalg.svd(raw, full_matrices=False)
    vanishing = ((S * S) / m <= psi).cpu().numpy()  # the degree's host read
    stats["svd_times"].append(time.perf_counter() - t0)
    idx_v = np.nonzero(vanishing)[0]
    idx_f = np.nonzero(~vanishing)[0]
    capped = len(idx_f) > cap
    idx_f = idx_f[:cap]
    iv = torch.as_tensor(idx_v, device=raw.device)
    jf = torch.as_tensor(idx_f, device=raw.device)
    combo = torch.cat([Vh[iv], Vh[jf] / torch.clamp(S[jf], min=1e-30)[:, None]]).T
    return combo, len(idx_v), len(idx_f), capped


def fit(X, config: VCAConfig = VCAConfig(), *, device=None) -> VCAModel:
    """Run VCA on ``X`` (m, n) in [0,1]^n.  ``device=None`` means the CUDA
    card (and raises without one); pass ``device="cpu"`` for the CPU."""
    dev = _device.resolve(device)
    t0 = time.perf_counter()
    dt = getattr(torch, config.dtype)
    np_dt = np.dtype(config.dtype)
    f64 = torch.float64
    X = _device.tensor(X, dt, dev)
    m, n = X.shape
    psi = config.psi
    cap = config.max_components_per_degree
    sqrt_m = float(np.sqrt(float(m)))
    stats: Dict = {"border_sizes": [], "degrees": [], "m": m, "n": n, "svd_times": []}

    # ---- degree 1 --------------------------------------------------------
    basis1 = torch.cat([X.new_ones((m, 1)), X], dim=1)  # (m, n+1)
    const = torch.full((m, 1), 1.0 / sqrt_m, dtype=f64, device=dev)
    mean_dir = const.T @ X.to(f64)  # (1, n)
    resid = X.to(f64) - const @ mean_dir  # mean-centered columns
    proj_coeff = mean_dir / sqrt_m  # (1, n) over the *raw* ones column
    C, kv1, _, _ = _split(resid, m, psi, n, stats)  # degree 1 is never capped
    # deg1 polys over [1, x]: x @ C - ones @ (proj_coeff @ C)
    deg1_coeffs = torch.cat([-(proj_coeff @ C), C], dim=0).to(dt)
    F1 = (basis1 @ deg1_coeffs)[:, kv1:]
    F_all = torch.cat([const, F1.to(f64)], dim=1)
    F_prev = F1
    stats["degrees"].append(1)
    stats["border_sizes"].append(n)

    blocks: List[_DegreeBlock] = []
    capped = False
    for d in range(2, config.max_degree + 1):
        if F_prev.shape[1] == 0 or F1.shape[1] == 0:
            stats["termination"] = "no_nonvanishing_left"
            break
        kf, kg = F_prev.shape[1], F1.shape[1]
        pair_f = np.repeat(np.arange(kf), kg).astype(np.int32)
        pair_g = np.tile(np.arange(kg), kf).astype(np.int32)
        cand = (F_prev[:, torch.as_tensor(pair_f, device=dev).long()]
                * F1[:, torch.as_tensor(pair_g, device=dev).long()]).to(f64)  # (m, K)
        proj = F_all.T @ cand  # (|F_all|, K)
        raw = cand - F_all @ proj
        combo, nv, nf, cut = _split(raw, m, psi, cap, stats)
        capped = capped or cut
        blocks.append(
            _DegreeBlock(
                pair_f=pair_f,
                pair_g=pair_g,
                proj=proj.cpu().numpy().astype(np_dt),
                combo=combo.cpu().numpy().astype(np_dt),
                num_vanishing=nv,
                num_nonvanishing=nf,
            )
        )
        stats["degrees"].append(d)
        stats["border_sizes"].append(len(pair_f))
        F_prev = (raw @ combo)[:, nv:]
        F_all = torch.cat([F_all, F_prev], dim=1)
        if nf == 0:
            stats["termination"] = "no_nonvanishing_left"
            break
    else:
        stats["termination"] = "max_degree"

    stats["time_total"] = time.perf_counter() - t0
    stats["capped"] = capped
    model = VCAModel(
        n=n,
        psi=psi,
        deg1_coeffs=deg1_coeffs.cpu().numpy(),
        deg1_num_vanishing=kv1,
        blocks=blocks,
        stats=stats,
        sqrt_m=sqrt_m,
        dtype=config.dtype,
        device=dev,
    )
    stats["num_G"] = model.num_G
    stats["num_O"] = model.num_F  # F plays the role of O for size comparisons
    stats["G_plus_O"] = model.num_G + model.num_F
    return model
