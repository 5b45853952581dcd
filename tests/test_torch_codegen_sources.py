"""Every source the port's policy code generators emit, held to a digest.

The host JIT (``jit.compile_program``: the Python of every generated
function), the native tier (``cc._CGen(...).generate()``: the C, built
here without a compiler) and the policy kernel (``cudac.emit_source(
...).full``: on the default frame routes, forced onto ``memory`` and
``regs``, and under a non-default symbol prefix) are emitted for a fixed
corpus and each source's sha256 is compared with ``codegen_sources.json``
beside this file.  The policy kernel's build cache keys on the hash of
its source, so an unchanged digest is the same ``bpf_<sha256>.so``.

The corpus: every shipped policy (``ALL_POLICIES``, the loop policies of
``policies/loops.py`` among them), the pair-form goldens and the loop
chains of ``torch_samples``, a fixed-seed handful of the property tests'
random programs, and two assembled programs that defeat the structured
walk: crossing forward jumps (the JIT's guard chain, the C and CUDA goto
skeletons) and a loop with two exits (the JIT's dispatcher, the goto
skeletons with CUDA's visit-counter resets).  ``test_corpus_reaches_every
_fallback`` keeps it that way.  Emission only: no compiler runs.

Regenerate the digests after a deliberate change to generated code with
``PYTHONPATH=src python tests/test_torch_codegen_sources.py --write``.
"""

import functools
import hashlib
import json
import random
import sys
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import pytest

import repro_torch.core as C
import torch_samples as samples
from repro_torch.core import cc, cudac, jit, torchc
from repro_torch.core.asm import assemble
from repro_torch.core.maps import MapRegistry
from repro_torch.core.verifier import verify_with_info
from repro_torch.policies import ALL_POLICIES
from test_torch_property_tiers import (_gen_call_policy, _gen_hash_policy,
                                       _seeded_program)

GOLDEN = Path(__file__).with_name("codegen_sources.json")
GROUPS = ("policies", "pair_goldens", "loop_chains", "property", "fallbacks")


def _crossing() -> str:
    """Each block jumps two ahead or falls into the next: the arms of
    every branch meet only at the end, so a structured walk duplicates
    blocks past its budget."""
    lines = ["ldxdw r6, [r1+msg_size]", "mov64 r0, 0"]
    for i in range(16):
        lines += [f"l{i}:", f"jset r6, {1 << i}, l{i + 2}",
                  f"add64i r0, {i + 1}"]
    lines += ["l16:", "add64i r0, 100", "l17:", "exit"]
    return "\n".join(lines)


_TWO_EXIT_LOOP = """
    ldxdw  r8, [r1+n_ranks]
    mov64  r6, 0
    mov64  r7, 0
loop:
    jge    r6, 10, out1
    jeq    r7, r8, out2
    add64i r7, 1
    add64i r6, 1
    ja     loop
out2:
    mov64  r0, 99
    exit
out1:
    mov64  r0, r7
    exit
"""


def _registry_maps(prog) -> dict:
    reg = MapRegistry()
    return {d.name: reg.create(d.name, d.kind, key_size=d.key_size,
                               value_size=d.value_size,
                               max_entries=d.max_entries)
            for d in prog.maps}


def _corpus(group: str) -> List[Tuple[str, object, dict]]:
    """``(name, program, resolved maps)`` of one corpus group."""
    if group == "policies":
        return [(p.program.name, p.program,
                 samples.make_maps(p.program, np.random.default_rng(0)))
                for p in ALL_POLICIES]
    if group in ("pair_goldens", "loop_chains"):
        gs = samples.pair_goldens() if group == "pair_goldens" \
            else samples.loop_chain_goldens()
        return [(g.id, g.program(C), g.host_maps(C)) for g in gs]
    if group == "property":
        out = []
        for seed in range(4):
            prog = _seeded_program(random.Random(0x515ED + seed))
            out.append((f"soup{seed}", prog, {}))
        for seed in range(3):
            prog, _ = _gen_hash_policy(seed)
            out.append((f"hash{seed}", prog, _registry_maps(prog)))
            prog = _gen_call_policy(seed)
            out.append((f"call{seed}", prog, {}))
        return out
    assert group == "fallbacks"
    return [(name, assemble(text, name=name, section="tuner"), {})
            for name, text in (("crossing", _crossing()),
                               ("two_exit_loop", _TWO_EXIT_LOOP))]


def _sources(prog, maps) -> Tuple[Dict[str, str], set]:
    """Every generated source of one program, by leg, and the fallbacks
    its generators took."""
    vinfo = verify_with_info(prog)
    taken = set()
    fn = jit.compile_program(prog, maps, info=vinfo)
    fns = {"jit": fn}
    fns.update((f"jit{n}", f) for n, f in
               sorted(getattr(fn, "__bpf_subs__", {}).items()))
    out = {}
    for leg, f in fns.items():
        out[leg] = f.__bpf_source__
        if not f.__bpf_structured__:
            taken.add("jit dispatcher" if "while True:" in f.__bpf_source__
                      else "jit guard chain")
    out["native"], structured = cc._CGen(prog, vinfo, maps).generate()
    if not structured:
        taken.add("native goto")
    try:
        torchc.check_supported(prog)
    except torchc.TorchcError:
        return out, taken
    variants = {"cuda": {}, "cuda-memory": {"route": "memory"},
                "cuda-prefix": {"prefix": "p7_"}}
    if "memory" not in map(cudac.frame_route, torchc.fn_infos(vinfo)):
        variants["cuda-regs"] = {"route": "regs"}
    for leg, kw in variants.items():
        src = cudac.emit_source(prog, vinfo, **kw)
        out[leg] = src.full
        if not src.structured:
            taken.add("cuda goto")
    return out, taken


@functools.lru_cache(maxsize=None)
def _emit(group: str) -> Tuple[Dict[str, str], frozenset]:
    """``group/program/leg -> sha256`` and the fallbacks taken."""
    digests, taken = {}, set()
    for name, prog, maps in _corpus(group):
        srcs, t = _sources(prog, maps)
        taken |= t
        for leg, src in srcs.items():
            digests[f"{group}/{name}/{leg}"] = \
                hashlib.sha256(src.encode()).hexdigest()
    return digests, frozenset(taken)


@pytest.mark.parametrize("group", GROUPS)
def test_generated_sources_unchanged(group):
    want = {k: v for k, v in json.loads(GOLDEN.read_text()).items()
            if k.startswith(group + "/")}
    got, _ = _emit(group)
    assert sorted(got) == sorted(want)
    changed = sorted(k for k in want if got[k] != want[k])
    assert not changed, f"{len(changed)} sources changed: {changed[:20]}"


def test_corpus_reaches_every_fallback():
    taken = set()
    for group in GROUPS:
        taken |= _emit(group)[1]
    assert taken == {"jit dispatcher", "jit guard chain", "native goto",
                     "cuda goto"}
    # the assembled programs take them, not some accident of the corpus
    assert _emit("fallbacks")[1] == taken


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit(f"usage: {sys.argv[0]} --write")
    table = {}
    for g in GROUPS:
        table.update(_emit(g)[0])
    GOLDEN.write_text(json.dumps(table, indent=0, sort_keys=True) + "\n")
    print(f"{len(table)} digests -> {GOLDEN}")
