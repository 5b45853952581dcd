"""A configuration file's deployment, made with the port: a
``PolicyRuntime`` on the configuration's tier with its programs attached
in the file's order and priorities, and the process-wide
``CollectiveDispatcher`` over it (the trainer's collectives and feeds go
to that one)."""

from __future__ import annotations

from typing import List, Optional, Tuple


def build(config: dict, tier: Optional[str] = None) -> Tuple[object, object]:
    """``(runtime, dispatcher)``.  On tier ``cuda`` the attached programs'
    policy kernels are built first, one nvcc each, in parallel (a later run
    in the same checkout loads them from ``build/``)."""
    import repro_torch.policies as pol
    from repro_torch.collectives.dispatch import reset_dispatcher
    from repro_torch.core.runtime import PolicyRuntime

    tier = tier or config["tier"]
    progs = [getattr(pol, a["program"]).program for a in config["attach"]]
    if tier == "cuda":
        from repro_torch.core.cudac import PolicyKernel, build_all
        from repro_torch.core.verifier import verify_with_info
        build_all(PolicyKernel(p, verify_with_info(p)) for p in progs)
    rt = PolicyRuntime(tier=tier)
    for a, p in zip(config["attach"], progs):
        rt.attach(p, priority=int(a["priority"]))
    return rt, reset_dispatcher(runtime=rt)


def links(rt) -> List[object]:
    """Every attached link, tuner chain first, in chain order."""
    return [l for s in rt.sections() for l in rt.chain(s)]


def bridge_calls(rt) -> dict:
    """Bridge calls so far by link id (0 where a tier has no bridge)."""
    return {l.link_id: getattr(getattr(l.fn, "stats", None), "calls", 0)
            for l in links(rt)}


def map_snapshots(rt) -> dict:
    """Every map's entries after the bridges have written back."""
    rt.flush_bridges()
    return {n: rt.maps.get(n).snapshot() for n in sorted(rt.maps.names())}
