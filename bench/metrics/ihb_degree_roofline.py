"""The candidate-loop kernel's share of its roofline (``kernels/ops.py``
-> ``ihb_update.cu`` ``ihb_degree_kernel``): the least time of the loop's
work on the fits' decisions, over the leading block of O they reached
(``bench/harness/work.py``), at the published H100 peaks, over the
profiler's device time of the kernel.  Traced runs only.

Unit ``%``; moves ``fit_s``."""

from ..harness import work


def read(run):
    secs = run.kernel_seconds("ihb_degree")
    if secs is None:
        return None
    flops, nbytes = run.work["ihb_degree"]
    n = len(run.stats)
    return work.roofline_share(flops * n, nbytes * n, secs)
