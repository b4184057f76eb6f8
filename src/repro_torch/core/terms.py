"""Monomial bookkeeping for OAVI: DegLex ordering and border construction.

Terms (monomials) over n variables are represented as exponent tuples
``(e_1, ..., e_n)``.  All combinatorics here are host-side Python: the number
of terms is bounded by Theorem 4.3 (``|G| + |O| <= C(D+n, D)``), i.e. a few
hundred in practice, while the numeric heavy lifting (evaluation vectors, Gram
updates, solves) lives in PyTorch code (see :mod:`repro_torch.core.oavi`).
A copy of the JAX package's ``repro.core.terms``: the port imports nothing of
that package, and its tests hold the two copies equal.

The degree-lexicographic order used by the paper (Section 2.2) enumerates,
for variables ``t < u < v``::

    1 < t < u < v < t^2 < tu < tv < u^2 < uv < v^2 < t^3 < ...

i.e. ascending total degree, and within a degree the term with the larger
exponent on the *earlier* variable comes first.  This corresponds to the sort
key ``(deg, tuple(-e_i))``.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

Term = Tuple[int, ...]


def degree(term: Term) -> int:
    return sum(term)


def deglex_key(term: Term) -> Tuple[int, Tuple[int, ...]]:
    """Sort key implementing the paper's DegLex order (ascending)."""
    return (sum(term), tuple(-e for e in term))


def constant_term(n: int) -> Term:
    return (0,) * n


def multiply_by_var(term: Term, j: int) -> Term:
    out = list(term)
    out[j] += 1
    return tuple(out)


def divide_by_var(term: Term, j: int) -> Term:
    assert term[j] > 0
    out = list(term)
    out[j] -= 1
    return tuple(out)


def immediate_divisors(term: Term) -> List[Term]:
    """All terms ``term / x_j`` for variables with positive exponent."""
    return [divide_by_var(term, j) for j in range(len(term)) if term[j] > 0]


def border(
    O_by_degree: Dict[int, List[Term]],
    d: int,
    n: int,
) -> List[Tuple[Term, Term, int]]:
    """Degree-``d`` border of the order ideal ``O`` (Definition 2.5).

    ``O_by_degree`` maps degree -> list of terms of that degree currently in
    ``O``.  Because OAVI only ever appends border terms, ``O`` is an order
    ideal (divisor-closed), so a degree-``d`` candidate lies in the border iff
    *all* its immediate (degree ``d-1``) divisors are in ``O``.

    Returns a DegLex-sorted list of ``(term, parent, var)`` triples where
    ``term = parent * x_var`` and ``parent`` is in ``O_{d-1}``; the evaluation
    vector of ``term`` is the elementwise product of ``parent``'s evaluation
    column and the ``var``-th data column.
    """
    prev = O_by_degree.get(d - 1, [])
    if not prev:
        return []
    prev_set = set(prev) if d > 1 else {constant_term(n)}
    # Candidate generation: multiply each degree-(d-1) term in O by each var.
    candidates: Dict[Term, Tuple[Term, int]] = {}
    for parent in prev:
        for j in range(n):
            cand = multiply_by_var(parent, j)
            if cand not in candidates:
                candidates[cand] = (parent, j)
    out: List[Tuple[Term, Term, int]] = []
    for cand, (parent, j) in candidates.items():
        if all(div in prev_set for div in immediate_divisors(cand)):
            out.append((cand, parent, j))
    out.sort(key=lambda tpl: deglex_key(tpl[0]))
    return out


def theorem_4_3_degree_bound(psi: float) -> int:
    """``D = ceil(-log(psi) / log(4))`` — the termination degree of Thm 4.3."""
    if psi <= 0:
        raise ValueError("Theorem 4.3 requires psi > 0")
    if psi >= 1:
        return 1
    return max(1, math.ceil(-math.log(psi) / math.log(4.0)))


def theorem_4_3_size_bound(psi: float, n: int) -> int:
    """``|G| + |O| <= C(D+n, D)`` (number-of-samples-agnostic bound)."""
    D = theorem_4_3_degree_bound(psi)
    return math.comb(D + n, D)


def tau_bound(psi: float) -> float:
    """Remark 4.5: ``tau >= (3/2)^D`` guarantees Thm 4.3 under (CCOP)."""
    D = theorem_4_3_degree_bound(psi)
    return 1.5**D


@dataclass
class TermBook:
    """Incremental registry of the terms in ``O`` (in DegLex order).

    Keeps, per term, the ``(parent_index, var)`` pair used to evaluate its
    column incrementally: ``col(term) = col(parent) * X[:, var]``.  Index 0 is
    the constant-1 term with sentinel parent ``(-1, -1)``.
    """

    n: int
    terms: List[Term] = field(default_factory=list)
    parents: List[int] = field(default_factory=list)
    vars: List[int] = field(default_factory=list)
    index: Dict[Term, int] = field(default_factory=dict)
    by_degree: Dict[int, List[Term]] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if not self.terms:
            one = constant_term(self.n)
            self.terms = [one]
            self.parents = [-1]
            self.vars = [-1]
            self.index = {one: 0}
            self.by_degree = {0: [one]}

    def __len__(self) -> int:
        return len(self.terms)

    def append(self, term: Term, parent: Term, var: int) -> int:
        idx = len(self.terms)
        self.terms.append(term)
        self.parents.append(self.index[parent] if degree(term) > 1 else 0)
        self.vars.append(var)
        self.index[term] = idx
        self.by_degree.setdefault(degree(term), []).append(term)
        return idx

    def border(self, d: int) -> List[Tuple[Term, Term, int]]:
        return border(self.by_degree, d, self.n)


def all_terms_up_to_degree(n: int, d: int) -> List[Term]:
    """All monomials in ``n`` variables of degree <= d, DegLex-sorted."""
    out: List[Term] = []
    for total in range(d + 1):
        for combo in itertools.combinations_with_replacement(range(n), total):
            exps = [0] * n
            for j in combo:
                exps[j] += 1
            out.append(tuple(exps))
    out = sorted(set(out), key=deglex_key)
    return out


def term_to_str(term: Term) -> str:
    if sum(term) == 0:
        return "1"
    parts = []
    for j, e in enumerate(term):
        if e == 1:
            parts.append(f"x{j}")
        elif e > 1:
            parts.append(f"x{j}^{e}")
    return "*".join(parts)
