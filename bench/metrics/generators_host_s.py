"""Algorithm 2's generator phase outside the class fits (``core/pipeline.py``):
the ``pipeline/generators`` span less its ``fit`` spans (``FitScope``), so
min-max scaling, the class split, ``api.fit_classes``'s grouping and the
models' construction, mean over the traced fits.  Traced runs of a program
that records the spans only.

Unit ``s``; moves ``fit_s``."""

import numpy as np

from ..harness import spans


def read(run):
    fits = spans.traced_fits(run)
    if fits is None:
        return None
    return float(np.mean([spans.self_seconds(f, "pipeline/generators", "fit") for f in fits]))
