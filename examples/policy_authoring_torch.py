"""Policy authoring tour on the PyTorch port: all three execution tiers of
one verified policy (``examples/policy_authoring.py`` on the JAX
package).

    PYTHONPATH=src python examples/policy_authoring_torch.py          # card
    PYTHONPATH=src python examples/policy_authoring_torch.py --cpu    # CPU

Shows: bytecode + disassembly, the verifier's abstract interpretation
catching each bug class, and the same program running on (a) the
interpreter, (b) the host JIT, (c) the in-graph tier — the pair-form CUDA
policy kernel (``InGraphSelector``, ``tier="cuda32"``) deciding on the
card with its map state threaded through the steps as device tensors.
``--cpu`` runs (c) on the kernel's plain PyTorch version
(``tier="torch"``); the decisions are the same.
"""

import argparse

from repro_torch.collectives.ingraph import InGraphSelector
from repro_torch.core import (PolicyRuntime, VerifierError, assemble,
                              make_ctx, map_decl, policy, verify)
from repro_torch.core.context import CollType

MiB = 1 << 20
hist = map_decl("hist", kind="array", value_size=8, max_entries=4)


@policy(section="tuner", maps=[hist])
def bucketizer(ctx):
    """Count decisions per size bucket; pick channels by bucket."""
    b = 0
    if ctx.msg_size > 1 * MiB:
        b = 1
    if ctx.msg_size > 32 * MiB:
        b = 2
    if ctx.msg_size > 256 * MiB:
        b = 3
    st = hist.lookup(b)
    if st is not None:
        st[0] = st[0] + 1
    ctx.n_channels = min(4 + b * 8, 32)
    return 0


def main(argv=None) -> dict:
    """Runs the tour; returns the decision lines it printed and the policy
    kernel that decided on the card (none with ``--cpu``)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run the in-graph tier on its plain PyTorch "
                         "version (tier torch)")
    args = ap.parse_args(argv)
    lines = []

    def say(line: str, decision: bool = False) -> None:
        print(line)
        if decision:
            lines.append(line)

    prog = bucketizer.program
    say(f"== compiled to {len(prog)} bytecode insns; disassembly head:")
    say("\n".join(prog.disasm().splitlines()[:8]) + " \n   ...")

    verify(prog)
    say("== verifier: ACCEPTED")

    say("\n== hand-written unsafe bytecode is still caught:")
    evil = assemble("""
        mov64  r2, 1
        stxdw  [r10-520], r2
        mov64  r0, 0
        exit
    """, section="tuner")
    try:
        verify(evil)
    except VerifierError as e:
        say(f"   REJECT: {e}", True)

    # tier A+B: interpreter vs host JIT
    for name, tier in [("interpreter", "interp"), ("host JIT", "jit")]:
        rt = PolicyRuntime(tier=tier)
        rt.load(prog)
        ctx = make_ctx("tuner", msg_size=64 * MiB)
        rt.invoke("tuner", ctx)
        say(f"== {name:12s}: 64 MiB -> channels={ctx['n_channels']}", True)

    # tier C: in-graph — the decision runs where the state lives, and the
    # state is threaded through the steps
    tier = "torch" if args.cpu else "cuda32"
    rt = PolicyRuntime(tier="jit")
    rt.load(prog)
    sel = InGraphSelector(prog, tier=tier)
    base = state = sel.init_state(rt.maps)
    for mib in (0.5, 8, 64, 512):
        _, nch, state = sel.decide(
            state, coll=CollType.ALL_REDUCE,
            msg_bytes=int(mib * MiB) & 0xFFFFFFFF, n=1)
        say(f"== in-graph ({tier}): {mib:>5} MiB -> channels={int(nch)}",
            True)
    # the device state back into the host map, then read per bucket
    sel.merge_shard_states(rt.maps, [state], base)
    counts = [rt.maps.get("hist").lookup_u64(b, 0) for b in range(4)]
    say(f"   bucket histogram carried as device state: {counts}", True)
    return {"lines": lines,
            "kernels": [sel.kernel] if sel.device.type == "cuda" else []}


if __name__ == "__main__":
    main()
