"""Deterministic fault injection at the runtime's trust boundaries.

The verifier makes policy programs *provably* unable to throw, loop
forever, or write out of bounds — which leaves the runtime's own trust
boundaries as the untestable residue: helper calls crossing from JIT'd
code into host Python, lock-held map read-modify-writes, the device
bridge's upload/download/flush path, tier compile/lowering during a hot
reload, and the dispatcher's ``decide()`` itself.  This module makes
those boundaries *testable* by letting a test (or benchmark) arm any of
them with a seeded, deterministic fault plan.

Usage::

    inj = FaultInjector(seed=7)
    inj.plan("bridge_upload", count=3)        # fail the first 3 uploads
    inj.plan("decide", prob=0.25)             # then 25% of decides
    with inj:                                 # install / uninstall
        run_workload()
    inj.stats()["decide"]["fires"]            # how many actually fired

Every instrumented boundary calls :func:`fire` with its point name.
When no injector is installed this is one global read and a ``None``
compare — cheap enough to leave in the production hot path.  Injection
points (``POINTS``):

``helper``           entering any helper from VM or JIT'd code
``map_rmw``          lock-held map read-modify-write (``ema_update``)
``hash_rmw``         hash-table insert-or-update (``map_update_elem`` /
                     ``ema_update`` against a hash map; detail is the
                     map name)
``call_fn``          bpf-to-bpf call entry (detail is the callee name)
``bridge_upload``    DeviceBridge host->device dirty-map upload
``bridge_download``  DeviceBridge device->host writeback
``bridge_flush``     DeviceBridge flush at a T3 boundary
``compile``          tier compile/lowering inside ``PolicyRuntime``
``decide``           dispatcher policy invocation

Determinism: probability plans draw from a private ``random.Random(seed)``
so the same seed and call sequence always fires the same subset; count /
``every`` plans are pure counters.
"""

from __future__ import annotations

import dataclasses
import random
import threading
from typing import Dict, Optional, Type

POINTS = (
    "helper",
    "map_rmw",
    "hash_rmw",
    "call_fn",
    "bridge_upload",
    "bridge_download",
    "bridge_flush",
    "compile",
    "decide",
)


class InjectedFault(Exception):
    """Raised by an armed injection point (default fault class)."""


@dataclasses.dataclass
class FaultPlan:
    """When an injection point fires.

    The decision per evaluation is: fire if this is one of the first
    ``count`` evaluations, OR every ``every``-th evaluation, OR with
    probability ``prob`` — capped at ``max_fires`` total.  ``match``
    restricts the plan to evaluations whose detail string contains it
    (e.g. only the ``pallas`` tier's compile, only one map's RMW).
    """
    prob: float = 0.0
    count: int = 0
    every: int = 0
    max_fires: Optional[int] = None
    exc: Type[BaseException] = InjectedFault
    match: Optional[str] = None
    evals: int = 0
    fires: int = 0


class FaultInjector:
    """Seeded, deterministic fault plan over the named injection points."""

    def __init__(self, seed: int = 0):
        self._rng = random.Random(seed)
        self._plans: Dict[str, FaultPlan] = {}
        self._lock = threading.Lock()

    def plan(self, point: str, *, prob: float = 0.0, count: int = 0,
             every: int = 0, max_fires: Optional[int] = None,
             exc: Type[BaseException] = InjectedFault,
             match: Optional[str] = None) -> "FaultInjector":
        if point not in POINTS:
            raise ValueError(f"unknown injection point {point!r}; "
                             f"known: {', '.join(POINTS)}")
        self._plans[point] = FaultPlan(prob=prob, count=count, every=every,
                                       max_fires=max_fires, exc=exc,
                                       match=match)
        return self

    def check(self, point: str, detail=None) -> None:
        p = self._plans.get(point)
        if p is None:
            return
        if p.match is not None and (detail is None
                                    or p.match not in str(detail)):
            return
        with self._lock:
            p.evals += 1
            if p.max_fires is not None and p.fires >= p.max_fires:
                return
            hit = (p.evals <= p.count
                   or (p.every > 0 and p.evals % p.every == 0)
                   or (p.prob > 0.0 and self._rng.random() < p.prob))
            if not hit:
                return
            p.fires += 1
            exc = p.exc
        raise exc(f"injected fault at {point}"
                  + (f" ({detail})" if detail is not None else ""))

    def stats(self) -> Dict[str, Dict[str, int]]:
        return {pt: {"evals": p.evals, "fires": p.fires}
                for pt, p in self._plans.items()}

    def reset_counters(self) -> None:
        for p in self._plans.values():
            p.evals = p.fires = 0

    # -- install / uninstall --------------------------------------------------
    def __enter__(self) -> "FaultInjector":
        install(self)
        return self

    def __exit__(self, *exc) -> None:
        uninstall(self)


_INJECTOR: Optional[FaultInjector] = None


def install(inj: FaultInjector) -> None:
    global _INJECTOR
    _INJECTOR = inj


def uninstall(inj: Optional[FaultInjector] = None) -> None:
    """Remove the installed injector (no-op if ``inj`` isn't current)."""
    global _INJECTOR
    if inj is None or _INJECTOR is inj:
        _INJECTOR = None


def active() -> Optional[FaultInjector]:
    return _INJECTOR


def fire(point: str, detail=None) -> None:
    """Instrumented-boundary hook: raise if an armed plan says so.

    The uninstalled fast path is a module-global load and a ``None``
    test; instrumentation stays enabled in production builds.
    """
    inj = _INJECTOR
    if inj is not None:
        inj.check(point, detail)
