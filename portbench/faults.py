"""Faults planted under the timed path, for the harness's own tests: each
breaks the port where it works and the test sees ``correct`` come out
false.  A run from the command line never plants one."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def planted(name):
    """Plant fault ``name`` (None: none) for the ``with`` block."""
    if name is None:
        yield
        return
    undo = FAULTS[name]()
    try:
        yield
    finally:
        undo()


def _patch(obj, attr, new):
    old = getattr(obj, attr)
    setattr(obj, attr, new)
    return lambda: setattr(obj, attr, old)


def altered_decision():
    """A decision altered where it is produced: the dispatcher's first
    decision and every 97th after it come back with one channel more."""
    import dataclasses

    from repro_torch.collectives import dispatch
    decide = dispatch.CollectiveDispatcher.decide
    count = [0]

    def bad(self, *a, **kw):
        d = decide(self, *a, **kw)
        count[0] += 1
        if count[0] % 97 == 1:
            d = dataclasses.replace(d, channels=d.channels + 1)
        return d
    return _patch(dispatch.CollectiveDispatcher, "decide", bad)


def frozen_feed():
    """A step that leaves its state unchanged: the profiler feed runs no
    program, so no map moves."""
    from repro_torch.collectives import dispatch
    return _patch(dispatch.CollectiveDispatcher, "profiler_feed",
                  lambda self, *a, **kw: None)


def frozen_step():
    """A training step that returns its state unchanged: the optimizer's
    update computes and then writes nothing back."""
    from repro_torch.train import step as st
    upd = st.adamw_update

    def same(params, grads, state, cfg, lr_scale=1.0, **kw):
        _, new_o, metrics = upd(params, grads, state, cfg, lr_scale, **kw)
        return params, state, metrics
    return _patch(st, "adamw_update", same)


def half_batch():
    """Half of the batch left out, the mean taken over the rest: the loss
    sees only the first half of the rows."""
    from repro_torch.train import step as st
    lb = st.local_batch

    def half(batch, *a, **kw):
        b = lb(batch, *a, **kw)
        n = b["tokens"].shape[0] // 2
        return {k: v[:n] for k, v in b.items()}
    return _patch(st, "local_batch", half)


FAULTS = {"altered_decision": altered_decision, "frozen_feed": frozen_feed,
          "frozen_step": frozen_step, "half_batch": half_batch}
