"""Set-up of the class-batched generator fit (``core/class_batch.py``
under ``core/oavi.py`` ``FitScope``): ``time_setup``, from the group's
scope entry to its first degree (feature ordering, scaling of the rows onto
the card, the buffers), mean over the window's fits.

Unit ``s``; moves ``fit_s``."""

def read(run):
    return run.mean("time_setup")
