"""Algorithm 2's generator phase a fit (``core/pipeline.py``): scaling
and the per-class fits, ``clf.stats["time_generators"]``, mean over the
window's fits.  Classifier cells only.

Unit ``s``; moves ``fit_s``."""

def read(run):
    return run.mean("time_generators")
