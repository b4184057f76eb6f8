"""The class-batched degree loop (``core/class_batch.py``, ``FitScope``):
``time_degrees``, each degree from its first launch to the host copy of its
decisions, summed over the degrees, mean over the window's fits.

Unit ``s``; moves ``fit_s``."""

def read(run):
    return run.mean("time_degrees")
