"""Algorithm 2's predict (``core/pipeline.py``): the ``pipeline/predict``
span of each traced fit (the device transform of the test rows, then the
host's decision ``svm/decision``), mean over the traced fits.  Traced runs
of a program that records the span only.

Unit ``s``; moves ``fit_s``."""

import numpy as np

from ..harness import spans


def read(run):
    fits = spans.traced_fits(run)
    if fits is None:
        return None
    return float(np.mean([spans.seconds(f, "pipeline/predict") for f in fits]))
