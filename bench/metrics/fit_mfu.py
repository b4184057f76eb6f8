"""The whole fit's share of the card's float32 peak: the work a fit needs
(the Gram and candidate-loop steps, the transform of every row, the SVM
head's products; ``bench/harness/work.py``), whatever computes it, over
the traced window's seconds a fit and the published 67 TFLOP/s.  Traced
runs only.

Unit ``%``; moves ``fit_s``."""

from ..harness import work


def read(run):
    if run.trace is None:
        return None
    return 100.0 * run.work["flops"] / (run.fit_s * work.PEAK_FP32_FLOPS)
