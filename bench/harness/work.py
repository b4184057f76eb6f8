"""The yardstick's arithmetic: the work a fit needs, counted from its
shapes and decisions, and the card's published peaks.

The counts are the least work of each step on the shapes the fit needs
(unpadded rows, the real number of O terms and border candidates), not the
work as the program dispatches it at capacity shapes.  The Gram and
candidate-loop counts are frozen copies of ``chip_smoke.py``'s
``gram_work`` and ``degree_work``; the candidate loop's output is counted
over the leading block of O that the decisions reached.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..reference.oavi import border

# one NVIDIA H100 SXM, published dense rates: float32 outside the tensor
# cores, and HBM3 bandwidth; both assume the card's full 700 W
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
F32 = 4


def gram(m: int, L: int, K: int, n: int) -> Tuple[float, float]:
    """One class's Gram step: the border ``B = A[:, p] * X[:, v]`` (m*K
    products), ``QL = A^T B`` (2*m*L*K) and the upper triangle of the
    symmetric ``C = B^T B`` (m*K*(K+1)); ``A``'s L columns and ``X`` read
    once, the indices read once, ``QL`` and ``C`` written once."""
    flops = m * K + 2.0 * m * L * K + 1.0 * m * K * (K + 1)
    nbytes = F32 * (m * L + m * n) + 2 * 8 * K + F32 * (L * K + K * K)
    return float(flops), float(nbytes)


def candidate_loop(accepted: Sequence[bool], ell0: int) -> Tuple[float, float]:
    """One class's candidate loop of a degree on its decisions: candidate
    ``a`` with ``ell_a`` terms in O costs the closed-form matvec and the
    Schur reduction (``2 ell_a^2 + 3 ell_a - ell0``), an appended one also
    the rank-1 update of the inverse (``3 ell_a^2 + 2 ell_a + 1``).  Bytes:
    each candidate's Gram row and its own entry read once, the starting
    inverse block read once and the final one written once, every
    coefficient vector (over the final block), MSE, slot and verdict
    written once."""
    acc = np.asarray(accepted, bool)
    K = int(acc.size)
    if K == 0:
        return 0.0, 0.0
    ells = ell0 + np.concatenate([[0], np.cumsum(~acc)[:-1]]).astype(np.float64)
    ell_f = ell0 + int((~acc).sum())
    flops = float(np.sum(2.0 * ells ** 2 + 3.0 * ells - ell0)
                  + np.sum((3.0 * ells ** 2 + 2.0 * ells + 1)[~acc]))
    nbytes = (F32 * (np.sum(2 * ells - ell0) + K + ell0 ** 2 + ell_f ** 2 + K * ell_f + K)
              + 8.0 * K + K + 4)
    return flops, float(nbytes)


def degree_steps(model: Dict, m: int, max_degree: int) -> List[Dict]:
    """Every degree of one fitted model (a plain model dict, see
    ``bench/reference/oavi.py``) on its ``m`` rows: its O size at the start,
    its border size, and the Gram and candidate-loop work."""
    O = [tuple(t) for t in model["O"]]
    G = {tuple(g[0]) for g in model["G"]}
    n = len(O[0])
    out = []
    ell = 1
    for d in range(1, max_degree + 1):
        cand = border(O[:ell], d, n)
        if not cand:
            break
        accepted = [t in G for t in cand]
        out.append({"d": d, "ell0": ell, "K": len(cand), "gram": gram(m, ell, len(cand), n),
                    "loop": candidate_loop(accepted, ell)})
        ell += accepted.count(False)
    return out


def transform(q: int, model: Dict) -> float:
    """(FT) of ``q`` rows by one model: one product a non-constant O term,
    then per generator its coefficient products and sums over the O terms
    it uses, the leading term's product and the absolute value."""
    per_row = (len(model["O"]) - 1) + sum(2.0 * len(g[1]) + 2.0 for g in model["G"])
    return float(q) * per_row


def fista(m: int, p: int, k: int, iters: int) -> float:
    """The SVM head's products: 21 power iterations of ``[X 1]^T ([X 1] v)``
    (the 21st for the Rayleigh quotient), then per FISTA iteration the
    scores ``X W`` and the gradient ``X^T g``."""
    return 21 * 4.0 * m * (p + 1) + iters * 4.0 * m * p * k


def roofline_share(flops: float, nbytes: float, seconds: float) -> float:
    """The least time the card could take for this work (the larger of its
    operations over the fp32 peak and its bytes over the HBM peak) as a
    percentage of ``seconds``."""
    return 100.0 * max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES) / seconds
