"""The SVM head's time a FISTA step (``core/svm.py``): the ``svm/fista``
span (the whole loop, its launches and its stop tests, ending with the last
stop test) over the fit's ``svm_iters``, in microseconds, mean over the
traced fits.  Against ``fista_enqueue_us`` it says whether the host's launching
or the device sets the loop's pace.  Traced runs of a program that records
the span only.

Unit ``us``; moves ``fit_s``."""

from ..harness import spans


def read(run):
    return spans.per_step_us(run, "svm/fista")
