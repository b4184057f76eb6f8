"""Record or replay the port's MoE routes in a test.

With random weights a router's softmax is near-uniform, so two runs that
differ only in roundings may send a few tokens to other experts.  A test
that compares such runs records the expert ids of every
``repro_torch.models.moe.route`` call in the first and replays them in the
others, the gates then being each run's own probabilities at those ids.
"""

import contextlib

from repro_torch.models import moe


@contextlib.contextmanager
def routes(monkeypatch, ids, record=True):
    """While entered, append each ``moe.route`` call's expert ids to
    ``ids``; with ``record=False``, hand ``ids`` back in order instead."""
    route = moe.route
    replay = iter(list(ids))

    def wrapped(h, router, dims):
        probs, gates, eidx = route(h, router, dims)
        if record:
            ids.append(eidx)
            return probs, gates, eidx
        eidx = next(replay)
        return probs, moe.gates_at(probs, eidx), eidx

    monkeypatch.setattr(moe, "route", wrapped)
    try:
        yield ids
    finally:
        monkeypatch.setattr(moe, "route", route)
