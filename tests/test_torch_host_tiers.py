"""The port's host tiers ``jit`` and ``native`` against the reference's.

For every shipped policy, seeded maps (``torch_samples.make_maps``, the
same seed filling a port and a reference registry alike) and a run of
seeded ctx samples go through

  the port's ``jit``     (``repro_torch.core.jit.compile_program``)
  the port's ``native``  (``repro_torch.core.cc.compile_native``)
  the port's ``interp``  (``repro_torch.core.vm.VM``)
  the reference's ``jit`` and ``native`` (``repro.core``)

with map state carried from one sample to the next.  Tolerance: none —
the return value, the ctx bytes and every map's bytes must be identical
after every sample.  The generated Python (``__bpf_source__``) and the
emitted C are identical across the two packages.  The ``native`` legs
need the system C compiler, which this host has; ``have_cc()`` decides
them in a fixture, not at import.

Then ``tier="auto"``, the closed loop of ``tests/test_torch_dispatch.py``
on ``CollectiveDispatcher(tier="jit"/"native")``, and a map shared by a
host-tier runtime and a runtime whose bridge holds it on the device.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.policies as ref_policies
import repro.policies.profiler as ref_profiler
import torch_samples as samples
from repro.core import cc as ref_cc
from repro.core import jit as ref_jit
from repro.core.maps import MapRegistry as RefRegistry
from repro.core.verifier import verify_with_info as ref_verify
from repro_torch.core import cc, jit
from repro_torch.core.context import make_ctx
from repro_torch.core.runtime import PolicyRuntime
from repro_torch.core.verifier import verify_with_info
from repro_torch.core.vm import VM
from repro_torch.policies import ALL_POLICIES, adapt_profiler, adapt_tuner

N_SAMPLES = 4
SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture
def native():
    if not cc.have_cc():
        pytest.skip("the native tier needs a C toolchain (have_cc)")


def _ref_program(name: str):
    return getattr(ref_policies, name, getattr(ref_profiler, name, None)
                   ).program


def _maps(prog, seed: int, registry=None):
    return samples.make_maps(prog, np.random.default_rng(seed), registry)


def _image(maps) -> dict:
    return {n: m.to_device().tobytes() for n, m in sorted(maps.items())}


def _legs(pol, seed: int, with_native: bool) -> dict:
    """leg name -> (fn, its maps), each leg on its own seeded maps."""
    prog = pol.program
    ref_prog = _ref_program(prog.name)
    vinfo, ref_vinfo = verify_with_info(prog), ref_verify(ref_prog)
    legs = {}
    m = _maps(prog, seed)
    legs["port interp"] = (VM(prog.insns, m, fuel=max(4 * vinfo.max_steps,
                                                      4096),
                              subprogs=prog.subprogs).run, m)
    m = _maps(prog, seed)
    legs["port jit"] = (jit.compile_program(prog, m, info=vinfo), m)
    m = _maps(prog, seed, RefRegistry())
    legs["reference jit"] = (ref_jit.compile_program(ref_prog, m,
                                                     info=ref_vinfo), m)
    if with_native:
        m = _maps(prog, seed)
        legs["port native"] = (cc.compile_native(prog, m, vinfo), m)
        m = _maps(prog, seed, RefRegistry())
        legs["reference native"] = (ref_cc.compile_native(ref_prog, m,
                                                          ref_vinfo), m)
    return legs


def _identical(pol, with_native: bool) -> None:
    prog = pol.program
    seed = sum(map(ord, prog.name))
    legs = _legs(pol, seed, with_native)
    rng = np.random.default_rng(seed + 1)
    for i in range(N_SAMPLES):
        buf = samples.make_ctx(prog, rng)
        got = {}
        for leg, (fn, maps) in legs.items():
            ctx = bytearray(buf)
            got[leg] = (fn(ctx), bytes(ctx), _image(maps))
        want = got["port interp"]
        for leg, g in got.items():
            assert g[0] == want[0], (leg, i, "ret")
            assert g[1] == want[1], (leg, i, "ctx")
            assert g[2] == want[2], (leg, i, "maps")


@pytest.mark.parametrize("pol", ALL_POLICIES, ids=lambda p: p.program.name)
def test_jit_identical_to_reference_and_interp(pol):
    _identical(pol, with_native=False)


@pytest.mark.parametrize("pol", ALL_POLICIES, ids=lambda p: p.program.name)
def test_native_identical_to_reference_and_interp(pol, native):
    _identical(pol, with_native=True)


@pytest.mark.parametrize("pol", ALL_POLICIES, ids=lambda p: p.program.name)
def test_generated_source_identical_to_reference(pol, native):
    """The v2 closure's Python and the native tier's C, character for
    character, and the same codegen labels."""
    prog = pol.program
    ref_prog = _ref_program(prog.name)
    m, rm = _maps(prog, 0), _maps(prog, 0, RefRegistry())
    fn = jit.compile_program(prog, m)
    ref_fn = ref_jit.compile_program(ref_prog, rm)
    assert fn.__bpf_source__ == ref_fn.__bpf_source__
    assert (fn.__bpf_codegen__, fn.__bpf_structured__) == \
        (ref_fn.__bpf_codegen__, ref_fn.__bpf_structured__)
    meta = cc.get_meta(cc.compile_native(prog, m))
    ref_meta = ref_cc.get_meta(ref_cc.compile_native(ref_prog, rm))
    assert meta["source"] == ref_meta["source"]
    assert (meta["codegen"], meta["structured"], meta["pure"]) == \
        (ref_meta["codegen"], ref_meta["structured"], ref_meta["pure"])


# the port's code generators walk the CFG through ``core/emit.py``, and
# its host JIT has one generator: these definitions are rewritten (their
# output is held to the reference's by
# test_generated_source_identical_to_reference), the others stay copies
_REWRITTEN = {
    "core/jit.py": {"_GenV2", "_compile_fn_v2", "_helper_env",
                    "compile_program"},
    "core/cc.py": {"_CGen"},
}


def _top_level(src: str) -> dict:
    """name -> source of each top-level def, class and assignment."""
    out = {}
    for node in ast.parse(src).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names = [node.name]
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = getattr(node, "targets", None) or [node.target]
            names = [t.id for t in targets if isinstance(t, ast.Name)]
        else:
            continue
        for name in names:
            out[name] = ast.get_source_segment(src, node)
    return out


@pytest.mark.parametrize("rel", [
    "core/jit.py", "core/cc.py", "core/maps.py", "core/helpers.py",
    "obs/__init__.py", "obs/recorder.py", "obs/exporter.py"])
def test_copies_equal_the_reference_but_for_names(rel):
    """The JAX-free modules come over as copies: only the package name in
    cross-references differs.  Native code reaches ``native_view()`` and
    ``helpers._PRNG_STATE`` by name, so maps and helpers stay verbatim.
    Of the host tiers' modules, every top-level definition but the
    rewritten code generators is the reference's, and the port adds
    none."""
    port = (SRC / "repro_torch" / rel).read_text() \
        .replace("repro_torch", "repro")
    ref = (SRC / "repro" / rel).read_text()
    if rel not in _REWRITTEN:
        assert port == ref
        return
    mine, theirs = _top_level(port), _top_level(ref)
    assert _REWRITTEN[rel] <= set(mine) <= set(theirs)
    kept = sorted(set(mine) - _REWRITTEN[rel])
    assert [mine[n] for n in kept] == [theirs[n] for n in kept]


def test_auto_tier_resolves_as_the_reference(monkeypatch):
    from repro.core.runtime import PolicyRuntime as RefRuntime
    assert PolicyRuntime(tier="auto").tier == RefRuntime(tier="auto").tier \
        == ("native" if cc.have_cc() else "jit")
    monkeypatch.setattr(cc, "_CC_PROBED", True)
    monkeypatch.setattr(cc, "_CC", None)
    monkeypatch.setattr(ref_cc, "_CC_PROBED", True)
    monkeypatch.setattr(ref_cc, "_CC", None)
    assert PolicyRuntime(tier="auto").tier == RefRuntime(tier="auto").tier \
        == "jit"
    # native without a toolchain degrades to the jit closure, as in the
    # reference, and the closure says so
    rt = PolicyRuntime(tier="native")
    assert rt.tier == "native"
    lp = rt.attach(ALL_POLICIES[0].program)
    assert lp.loaded.fn.__bpf_codegen__ == "v2"


def test_default_tier_stays_cuda():
    from repro_torch.collectives.dispatch import CollectiveDispatcher
    from repro_torch.core.runtime import global_runtime, reset_global_runtime
    from repro_torch.device import DeviceError
    assert PolicyRuntime.TIERS == ("cuda", "cuda32", "torch", "interp",
                                   "jit", "native")
    reset_global_runtime()
    try:
        with pytest.raises(DeviceError):
            PolicyRuntime()
        with pytest.raises(DeviceError):
            global_runtime()
        with pytest.raises(DeviceError):
            CollectiveDispatcher()
    finally:
        reset_global_runtime()
    with pytest.raises(ValueError, match="unknown tier"):
        PolicyRuntime(tier="pallas")


# ---------------------------------------------------------------------------
# the §5.3 closed loop on the dispatcher's host tiers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tier", ["jit", "native", "auto"])
def test_closed_loop_on_host_tiers_matches_reference(tier):
    """256 decisions with a warm ``link.replace()`` half way: every
    ``Decision`` and every final map byte equal to the port's ``interp``
    and ``torch`` runs and to the reference's run on the same tier."""
    import repro.policies as ref_pols
    from repro.collectives import CollectiveDispatcher as RefDispatcher

    import repro_torch.policies as pols
    from repro_torch.collectives import CollectiveDispatcher

    stream = samples.decision_stream(256)

    def drive(Dispatcher, pols, tier):
        return samples.drive_closed_loop(Dispatcher, pols, tier, stream)[:2]

    want = drive(CollectiveDispatcher, pols, "interp")
    assert drive(CollectiveDispatcher, pols, tier) == want
    assert drive(CollectiveDispatcher, pols, "torch") == want
    assert drive(RefDispatcher, ref_pols, tier) == want
    assert drive(RefDispatcher, ref_pols, "interp") == want


# ---------------------------------------------------------------------------
# a pinned map shared by a host tier and a device bridge (ROADMAP C1)
# ---------------------------------------------------------------------------

def _shared_adapt_map(bridge_tier: str, host_tier: str) -> np.ndarray:
    """adapt_tuner on a runtime whose bridge holds adapt_map on the
    device; adapt_profiler on a host-tier runtime over the same
    registry, writing the map between bridge calls; then a
    ``link.replace()`` (a T3 flush) of the tuner."""
    dev = PolicyRuntime(tier=bridge_tier)
    host = PolicyRuntime(tier=host_tier)
    host.maps = dev.maps
    link = dev.attach(adapt_tuner.program)
    host.attach(adapt_profiler.program)
    for comm in (3, 5):
        dev.invoke("tuner", make_ctx("tuner", comm_id=comm))
        for lat in (1000, 2000, 3000):
            host.invoke("profiler", make_ctx("profiler", comm_id=comm,
                                             latency_ns=lat * comm))
    # the tuner's device copy predates the comm-5 samples
    link.replace(adapt_tuner.program)
    dev.invoke("tuner", make_ctx("tuner", comm_id=5))
    dev.flush_bridges()
    return dev.maps.get_pinned("adapt_map").to_device()


@pytest.mark.parametrize("host_tier", ["jit", "native"])
def test_bridge_flush_keeps_host_tier_writes(host_tier):
    """The flush writes back only maps with unflushed kernel writes, so
    the profiler's host-tier samples survive the tuner's stale device
    copy; the result equals both runtimes on ``interp``."""
    want = _shared_adapt_map("interp", "interp")
    got = _shared_adapt_map("torch", host_tier)
    assert (got == want).all()
    assert want[3, 2] == 3 and want[5, 2] == 3     # every sample kept


@pytest.mark.cuda
@pytest.mark.parametrize("host_tier", ["jit", "native"])
def test_bridge_flush_keeps_host_tier_writes_on_the_card(host_tier):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.device import have_nvcc
    if not have_nvcc():
        pytest.skip("needs nvcc")
    want = _shared_adapt_map("interp", "interp")
    assert (_shared_adapt_map("cuda", host_tier) == want).all()
