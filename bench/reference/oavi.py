"""OAVI, Algorithm 1 of the paper, written plainly, and the judge of a
fitted model.

A model here is a plain dict, the form into which the benchmark's entries
copy the program's fitted models:

* ``perm``: the feature order the fit used (``Z = X[:, perm]``);
* ``O``: the order ideal's terms (exponent tuples over the ordered
  features) in the order they were appended, the constant term first;
* ``G``: the generators, each ``(leading term, coefficients over the first
  len(coefficients) terms of O, claimed MSE)``, in the order accepted.

:func:`fit` runs the algorithm itself and makes its own decisions; at
``prec="tf32"`` it is the control.  :func:`judge` holds a model to the
algorithm at float64 on the same data.  At a candidate whose MSE lies within
the rounding of float32 of ``psi``, float32 may decide either way, so the
judge does not re-decide: it follows the model's own decisions, derives
every border from the model's O, solves every least-squares problem again
on the O the model had at that candidate, and reports how far each decision
and each claimed number lies from the float64 solution.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import prec as prec_mod

Term = Tuple[int, ...]


def deglex_key(term: Term):
    """The paper's DegLex order: ascending degree, then the larger exponent
    on the earlier variable first."""
    return (sum(term), tuple(-e for e in term))


def border(O_terms: Sequence[Term], d: int, n: int) -> List[Term]:
    """The degree-``d`` border of the order ideal ``O``: every degree-``d``
    term whose immediate divisors all lie in ``O``, in DegLex order."""
    prev = {t for t in O_terms if sum(t) == d - 1}
    out = set()
    for t in prev:
        for j in range(n):
            c = list(t)
            c[j] += 1
            c = tuple(c)
            divisors = [c[:i] + (c[i] - 1,) + c[i + 1:] for i in range(n) if c[i] > 0]
            if all(dv in prev for dv in divisors):
                out.add(c)
    return sorted(out, key=deglex_key)


def pearson_order(X: np.ndarray) -> np.ndarray:
    """Algorithm 5: features in increasing order of their summed absolute
    Pearson correlation with every feature (ties by index); a constant
    feature correlates with nothing but itself."""
    X = np.asarray(X, np.float64)
    Xc = X - X.mean(axis=0, keepdims=True)
    std = np.sqrt((Xc * Xc).sum(axis=0))
    denom = np.outer(std, std)
    with np.errstate(divide="ignore", invalid="ignore"):
        r = np.where(denom > 0, (Xc.T @ Xc) / np.maximum(denom, 1e-300), 0.0)
    np.fill_diagonal(r, 1.0)
    return np.argsort(np.abs(r).sum(axis=1), kind="stable").astype(np.int64)


def term_column(Z: torch.Tensor, cols: Dict[Term, torch.Tensor], term: Term) -> torch.Tensor:
    """The evaluation column of ``term``: its parent's column (the term
    divided by its first variable) times that variable."""
    j = next(i for i, e in enumerate(term) if e > 0)
    parent = term[:j] + (term[j] - 1,) + term[j + 1:]
    return cols[parent] * Z[:, j]


def _solve_block(O: torch.Tensor, B: torch.Tensor):
    """Least squares of every column of ``B`` on the columns of ``O``
    (``min_c |O c + b|^2 / m``) by a direct solve: coefficients (ell, K),
    MSEs (K,) and the normalized Gram ``O^T O / m``."""
    m = O.shape[0]
    G = O.T @ O / m
    Q = O.T @ B / m
    btb = (B * B).sum(dim=0) / m
    Y = torch.linalg.solve(G, Q)
    mse = btb - (Q * Y).sum(dim=0)
    return -Y, mse, G


def fit(X: np.ndarray, psi: float, max_degree: int, prec: str = "fp64",
        device="cpu") -> Dict:
    """OAVI on the rows ``X`` (m, n) in [0, 1]^n, deciding every candidate
    itself, as the paper's fast engine does: the normalized Gram
    ``q = O^T b / m`` and ``b^T b / m`` of each candidate, the closed-form
    optimum ``y = -N q`` from the inverse ``N = (O^T O / m)^-1`` kept by
    Theorem 4.9's block update, and the MSE ``b^T b / m + q^T y``; accepted
    as a generator at ``mse <= psi``, appended to O otherwise.  Returns the
    plain model dict (coefficients in ``prec``'s float type, as numpy)."""
    dt = prec_mod.dtype(prec)
    perm = pearson_order(X)
    Z = torch.as_tensor(np.asarray(X)[:, perm], device=device).to(dt)
    m, n = Z.shape
    psi_t = torch.tensor(psi, dtype=dt).item()
    one = (0,) * n
    cols = {one: torch.ones(m, dtype=dt, device=device)}
    N = torch.ones((1, 1), dtype=dt, device=device)
    O: List[Term] = [one]
    G: List = []
    for d in range(1, max_degree + 1):
        cand = border(O, d, n)
        if not cand:
            break
        B = torch.stack([term_column(Z, cols, t) for t in cand], dim=1)
        i = 0
        while i < len(cand):
            Ocols = torch.stack([cols[t] for t in O], dim=1)
            Q = prec_mod.mm(Ocols.T, B[:, i:], prec) / m
            Y = -prec_mod.mm(N, Q, prec)
            mse = (B[:, i:] * B[:, i:]).sum(dim=0) / m + (Q * Y).sum(dim=0)
            mse_h = mse.cpu().numpy()
            rej = np.nonzero(mse_h > psi_t)[0]
            stop = int(rej[0]) if rej.size else len(cand) - i
            coef_h = Y[:, :stop].cpu().numpy()
            for a in range(stop):
                G.append((cand[i + a], coef_h[:, a].copy(), float(mse_h[a])))
            if not rej.size:
                break
            # Theorem 4.9: the inverse grown by the appended column
            u, s = -Y[:, stop], mse[stop]
            ell = N.shape[0]
            grown = torch.empty((ell + 1, ell + 1), dtype=dt, device=device)
            grown[:ell, :ell] = N + u[:, None] * u[None, :] / s
            grown[:ell, ell] = -u / s
            grown[ell, :ell] = -u / s
            grown[ell, ell] = 1.0 / s
            N = grown
            t = cand[i + stop]
            cols[t] = B[:, i + stop]
            O.append(t)
            i += stop + 1
    return {"perm": perm, "O": O, "G": G}


def _structure_errors(model: Dict, n: int, max_degree: int, psi: float) -> List[str]:
    """What in the model's structure contradicts the algorithm, as
    messages: O starts with the constant, every degree's candidates are the
    border of the O before it, in DegLex order, each either appended or
    accepted, every coefficient vector as long as O was at its candidate,
    every claimed MSE on its verdict's side of psi, and the fit stops where
    the border is empty or the degree limit is reached."""
    errs: List[str] = []
    O, G = [tuple(int(e) for e in t) for t in model["O"]], model["G"]
    if not O or O[0] != (0,) * n:
        return ["O does not start with the constant term"]
    if any(len(t) != n for t in O) or any(len(g[0]) != n for g in G):
        return ["a term has the wrong number of variables"]
    psi32 = float(np.float32(psi))
    top = max([sum(t) for t in O] + [sum(g[0]) for g in G])
    ell = 1
    for d in range(1, top + 2):
        cand = border(O[:ell], d, n)
        O_d = [t for t in O if sum(t) == d]
        G_d = [tuple(int(e) for e in g[0]) for g in G if sum(g[0]) == d]
        if d > max_degree:
            if O_d or G_d:
                errs.append(f"degree {d} beyond the limit {max_degree}")
            break
        if sorted(O_d + G_d, key=deglex_key) != cand:
            errs.append(f"degree {d}: candidates are not the border of O")
            break
        if O_d != sorted(O_d, key=deglex_key) or G_d != sorted(G_d, key=deglex_key):
            errs.append(f"degree {d}: terms out of DegLex order")
        if O[ell:ell + len(O_d)] != O_d:
            errs.append(f"degree {d}: O is not in degree order")
            break
        ell += len(O_d)
    for g in G:
        if not (np.isfinite(g[2]) and g[2] <= psi32):
            errs.append(f"generator {g[0]} claims MSE {g[2]!r} above psi")
    return errs


def judge(X: np.ndarray, model: Dict, psi: float, max_degree: int, device="cpu") -> Dict:
    """Hold one fitted model to the algorithm on its rows ``X`` at float64.

    Returns ``structure`` (messages; empty when sound, see
    :func:`_structure_errors`, and the feature order against this file's
    own), and where the structure holds:

    * ``verdict``: the furthest any decision lies on the wrong side of psi
      by the float64 MSE, as a share of psi (0 when every decision agrees);
    * ``mse_gap``: the largest gap between a generator's claimed MSE and
      the float64 MSE of its candidate, as a share of psi;
    * ``coef_excess``: the largest excess MSE of a generator's coefficients
      over the float64 least-squares optimum, ``(c - c*)^T G (c - c*)``,
      as a share of psi;
    * ``coef``: the float64 optimum of every generator, in the model's
      order (for the features).
    """
    X = np.asarray(X)
    m, n = X.shape
    perm = pearson_order(X)
    out = {"structure": [], "verdict": np.inf, "mse_gap": np.inf, "coef_excess": np.inf,
           "coef": None}
    if not np.array_equal(np.asarray(model["perm"], np.int64), perm):
        out["structure"].append("feature order differs from the Pearson order")
        return out
    errs = _structure_errors(model, n, max_degree, psi)
    if errs:
        out["structure"] = errs
        return out
    Z = torch.as_tensor(X[:, perm], device=device).to(torch.float64)
    O = [tuple(int(e) for e in t) for t in model["O"]]
    G = model["G"]
    gi = {tuple(int(e) for e in g[0]): j for j, g in enumerate(G)}
    one = (0,) * n
    cols = {one: torch.ones(m, dtype=torch.float64, device=device)}
    ell = 1
    verdict = mse_gap = excess = 0.0
    coef_ref: List = [None] * len(G)
    d = 0
    while True:
        d += 1
        cand = border(O[:ell], d, n)
        if not cand or d > max_degree:
            break
        B = torch.stack([term_column(Z, cols, t) for t in cand], dim=1)
        i = 0
        while i < len(cand):
            # candidates up to and including the model's next appended one
            stop = next((a for a in range(i, len(cand)) if cand[a] not in gi), len(cand) - 1)
            Ocols = torch.stack([cols[t] for t in O[:ell]], dim=1)
            coef, mse, Gm = _solve_block(Ocols, B[:, i:stop + 1])
            mse_h = mse.cpu().numpy()
            for a in range(i, stop + 1):
                t, r = cand[a], float(mse_h[a - i])
                j = gi.get(t)
                if j is None:
                    verdict = max(verdict, (psi - r) / psi)
                    continue
                verdict = max(verdict, (r - psi) / psi)
                c_prog = np.asarray(G[j][1], np.float64)
                if c_prog.shape != (ell,):
                    out["structure"].append(f"generator {t}: {c_prog.shape[0]} coefficients "
                                            f"for {ell} terms of O")
                    return out
                mse_gap = max(mse_gap, abs(float(G[j][2]) - r) / psi)
                dc = torch.as_tensor(c_prog, device=device) - coef[:, a - i]
                excess = max(excess, float(dc @ (Gm @ dc)) / psi)
                coef_ref[j] = coef[:, a - i].cpu().numpy()
            if cand[stop] not in gi:
                cols[cand[stop]] = B[:, stop]
                ell += 1
            i = stop + 1
    out.update(verdict=verdict, mse_gap=mse_gap, coef_excess=excess, coef=coef_ref)
    return out


def evaluate(X: np.ndarray, model: Dict, coefs: Sequence[np.ndarray], prec: str = "fp64",
             device="cpu") -> torch.Tensor:
    """(FT) of one model: ``|g(X)|`` for every generator ``g``, its leading
    term plus ``coefs[j]`` over the first terms of O, as a (q, |G|) tensor
    in ``prec``'s float type."""
    dt = prec_mod.dtype(prec)
    Z = torch.as_tensor(np.asarray(X)[:, np.asarray(model["perm"])], device=device).to(dt)
    q, n = Z.shape
    O = [tuple(int(e) for e in t) for t in model["O"]]
    cols = {O[0]: torch.ones(q, dtype=dt, device=device)}
    for t in O[1:]:
        cols[t] = term_column(Z, cols, t)
    Ocols = torch.stack([cols[t] for t in O], dim=1)
    if not model["G"]:
        return Ocols.new_zeros((q, 0))
    C = torch.zeros((len(O), len(model["G"])), dtype=dt, device=device)
    lead = []
    for j, g in enumerate(model["G"]):
        c = torch.as_tensor(np.asarray(coefs[j]), device=device).to(dt)
        C[: c.shape[0], j] = c
        lead.append(term_column(Z, cols, tuple(int(e) for e in g[0])))
    return torch.abs(prec_mod.mm(Ocols, C, prec) + torch.stack(lead, dim=1))
