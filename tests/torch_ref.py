"""The reference package's interpreter beside the port's tiers.

The host-tier suites ported onto ``repro_torch`` (``test_torch_jit_v2``,
``test_torch_property_tiers``, ``test_torch_loops``, ...) compare the
port's tiers with each other; the reference's own ``interp`` result on
the same inputs joins each such comparison.  This module turns a port
program or map into the reference's (the same instructions, subprograms,
declarations and map bytes) and runs the reference VM on them.

A helper of the tests, not part of either package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro.core import isa as ref_isa
from repro.core import program as ref_program
from repro.core.maps import MapRegistry as RefRegistry
from repro.core.vm import VM as RefVM


def _insns(seq):
    return [ref_isa.Insn(**dataclasses.asdict(i)) for i in seq]


def program(prog):
    """The port's ``Program`` as the reference's."""
    return ref_program.Program(
        prog.name, prog.section, _insns(prog.insns),
        maps=tuple(ref_program.MapDecl(**dataclasses.asdict(d))
                   for d in prog.maps),
        source=prog.source,
        subprogs=tuple(ref_program.SubProgram(sp.name, tuple(_insns(
            sp.insns)), sp.n_args) for sp in prog.subprogs))


def maps(port_maps: Optional[Dict]) -> Dict:
    """Reference maps holding the port maps' state (their device images,
    which is what the suites compare)."""
    reg = RefRegistry()
    out = {}
    for name, m in (port_maps or {}).items():
        r = reg.create(name, m.kind, key_size=m.key_size,
                       value_size=m.value_size, max_entries=m.max_entries)
        r.from_device(m.to_device())
        out[name] = r
    return out


def images(maps_: Dict) -> Dict[str, bytes]:
    """Every map's device image, by name: what the suites compare."""
    return {n: m.to_device().tobytes() for n, m in sorted(maps_.items())}


def interp(prog, ctx_buf, port_maps: Optional[Dict] = None,
           **vm_kw) -> Tuple[int, bytes, Dict[str, bytes]]:
    """The reference VM on ``prog`` (a port program), a copy of
    ``ctx_buf`` and maps holding ``port_maps``' state: ``(ret, ctx bytes,
    map images)``.  Leaves the arguments untouched."""
    ref = program(prog)
    rmaps = maps(port_maps)
    buf = bytearray(ctx_buf)
    ret = RefVM(ref.insns, rmaps, subprogs=ref.subprogs, **vm_kw).run(buf)
    return ret, bytes(buf), images(rmaps)
