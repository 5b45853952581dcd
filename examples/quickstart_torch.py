"""Quickstart on the PyTorch port: write a policy, verify it, watch it
govern real collectives (``examples/quickstart.py`` on the JAX package).

    PYTHONPATH=src python examples/quickstart_torch.py          # the card
    PYTHONPATH=src python examples/quickstart_torch.py --cpu    # CPU

Covers the paper's full arc in one file:
  1. author a restricted-Python policy (compiled to eBPF-style bytecode)
  2. load-time verification (a buggy variant is REJECTED with the fix)
  3. the verified policy drives the framework's collective dispatch
  4. atomic hot-reload mid-run

The policy runs on the CUDA policy kernel (``tier="cuda"``) unless
``--cpu`` asks for the host JIT (``tier="jit"``); the decisions are the
same either way.
"""

import argparse

from repro_torch.collectives.dispatch import reset_dispatcher
from repro_torch.core import PolicyRuntime, VerifierError, map_decl, policy
from repro_torch.core.context import Algo, CollType, Proto

ALGO_RING, ALGO_TREE = Algo.RING, Algo.TREE
PROTO_SIMPLE, PROTO_LL = Proto.SIMPLE, Proto.LL
MiB = 1 << 20

# --- 1. author a policy ------------------------------------------------------
stats = map_decl("stats", kind="array", value_size=16, max_entries=8)


@policy(section="tuner", maps=[stats])
def my_tuner(ctx):
    """Small messages: latency-optimized tree; big: bandwidth ring."""
    st = stats.lookup(0)
    if st is not None:
        st[0] = st[0] + 1          # decision counter
    if ctx.msg_size <= 1 * MiB:
        ctx.algorithm = ALGO_TREE
        ctx.protocol = PROTO_LL
        ctx.n_channels = 4
    else:
        ctx.algorithm = ALGO_RING
        ctx.protocol = PROTO_SIMPLE
        ctx.n_channels = 16
    return 0


# --- 2. verification: the unsafe variant is caught at load time -------------
@policy(section="tuner", maps=[stats])
def my_buggy_tuner(ctx):
    st = stats.lookup(0)
    st[0] = st[0] + 1              # BUG: no None check
    return 0


def main(argv=None) -> dict:
    """Runs the tour; returns the decision lines it printed and the policy
    kernels that decided on the card (none with ``--cpu``)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run the policy on the host JIT (tier jit)")
    args = ap.parse_args(argv)
    lines = []

    def say(line: str, decision: bool = False) -> None:
        print(line)
        if decision:
            lines.append(line)

    rt = PolicyRuntime(tier="jit" if args.cpu else "cuda")
    say(f"== loading buggy policy (must be rejected) [tier {rt.tier}]")
    try:
        rt.load(my_buggy_tuner.program)
    except VerifierError as e:
        say(f"   VERIFIER REJECT: {e}", True)
    say("== loading safe policy")
    lp = rt.load(my_tuner.program)
    say(f"   verified in {lp.verify_ms:.2f} ms, compiled in "
        f"{lp.jit_ms:.2f} ms")

    # --- 3. the policy governs real collectives -----------------------------
    disp = reset_dispatcher(runtime=rt)
    kernels = _kernels(rt)
    for size_mib in (0.5, 8):
        n = int(size_mib * MiB / 4)
        d = disp.decide(CollType.ALL_REDUCE, n * 4, 8, axis_name="model")
        say(f"   {size_mib:>4} MiB -> {Algo.NAMES[d.algo]}/"
            f"{Proto.NAMES[d.proto]}/ch{d.channels}", True)
    rt.flush_bridges()      # the card's map state back to the host maps
    say(f"   decisions counted in shared map: "
        f"{rt.maps.get('stats').lookup_u64(0, 0)}", True)

    # --- 4. atomic hot-reload -------------------------------------------------
    from repro_torch.policies import bad_channels
    say("== hot-reload to bad_channels (verified but destructive)")
    rt.reload(bad_channels.program)
    kernels += _kernels(rt)
    d = disp.decide(CollType.ALL_REDUCE, 8 * MiB, 8, axis_name="model")
    say(f"   after reload: {Algo.NAMES[d.algo]}/ch{d.channels} "
        "(the verifier stops crashes, not bad decisions — paper §5.3)", True)
    return {"lines": lines, "kernels": kernels}


def _kernels(rt) -> list:
    """The policy kernels behind the runtime's attached links."""
    return [link.fn.kernel for s in rt.sections() for link in rt.chain(s)
            if hasattr(link.fn, "kernel")]


if __name__ == "__main__":
    main()
