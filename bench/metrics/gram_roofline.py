"""The batched Gram kernel's share of its roofline (``kernels/ops.py``
-> ``gram_update.cu``): the least time of the Gram work the window's fits
need (unpadded rows, the real O and border sizes; ``bench/harness/work.py``)
at the published H100 peaks, over the profiler's device time of every kernel
named ``gram_``.  Traced runs only.

Unit ``%``; moves ``fit_s``."""

from ..harness import work


def read(run):
    secs = run.kernel_seconds("gram_")
    if secs is None:
        return None
    flops, nbytes = run.work["gram"]
    n = len(run.stats)
    return work.roofline_share(flops * n, nbytes * n, secs)
