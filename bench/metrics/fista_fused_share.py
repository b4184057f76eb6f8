"""Share of the SVM head's FISTA steps issued through the fused kernel
(``core/svm.py``, ``csrc/fista_step.cu``): the ``fused`` args of the traced
fits' ``svm/fista_block`` spans over their ``svm_iters``, in percent.  A
block issues no step past ``max_iter``, so a fit that runs to it reads 100;
one stopped by its tolerance counts the masked tail of its last block too.
Traced runs of a program whose blocks carry the arg only.

Unit ``%``; moves ``fit_s``."""

from ..harness import spans


def read(run):
    fits = spans.traced_fits(run)
    if fits is None or not all(s.get("svm_iters") for s in run.stats):
        return None
    blocks = [s for f in fits for s in f if s.name == "svm/fista_block"]
    if not blocks or not all("fused" in s.args for s in blocks):
        return None
    return 100.0 * sum(s.args["fused"] for s in blocks) / sum(s["svm_iters"] for s in run.stats)
