"""The card's idle share of the traced window: the time in which no
kernel, copy or fill ran on it, from ``torch.profiler``'s device events,
over the window.  Traced runs only.

Unit ``%``; moves ``fit_s``."""

def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
