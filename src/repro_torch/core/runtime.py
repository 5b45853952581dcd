"""PolicyRuntime — link-based load/verify/JIT/attach lifecycle, the
bpftime analogue grown to kernel-style multi-program attachment.

Lifecycle of a policy (paper §4), now mediated by first-class links:

    link = runtime.attach(program, priority=...)   # verify -> JIT -> attach
    link.replace(new_program)                       # verify-then-CAS swap
    link.detach()                                   # remove from the chain
    runtime.load_bundle([prog_a, prog_b, ...])      # all-or-nothing multi-swap

Each hook section holds an ordered **chain** of links (the ``bpf_link`` +
multi-prog attach model).  Chain order is ascending ``priority`` with attach
order breaking ties; *lower priority number = higher precedence*.  The
composition semantics per section mirror what each hook means:

  * ``tuner``     — first-non-deferring-wins: programs run in chain order;
                    the first one that writes any output field (algorithm /
                    protocol / n_channels) decides, the rest never run.  A
                    program that leaves all outputs zero has deferred.
  * ``profiler``/``net`` — invoke-all: observability hooks; every program in
                    the chain sees every event, in chain order.
  * ``env``       — last-writer-wins: programs run in *reverse* chain order
                    so the highest-precedence (lowest priority number) link
                    writes last; zero-valued outputs mean "keep", so lower-
                    precedence links still fill fields the winner left alone.

The chain is executed through a **fused closure** built once per mutation:
depth-1 chains collapse to a thin wrapper over the program's JIT'd function,
so the PR-1 fast path survives intact.  Invocation counting lives in the
fused closure, so ``invoke()`` and raw ``invoke_fn()`` callers both land in
``stats.invocations``.

Atomicity: every mutation (attach / detach / replace / bundle swap)
rebuilds the affected chains and publishes each by a single reference
assignment (atomic under the GIL — the CPython analogue of the paper's
compare-and-swap on a function pointer).  In-flight invocations keep using
the closure they already read; no call is ever lost.  The epoch counter
bumps exactly once per mutation — ``load_bundle`` verifies *every* program
before touching anything and then swaps all affected chains under one
epoch bump, so multi-policy updates are atomic end-to-end; a rejection
leaves the previous chains fully attached and the epoch untouched.  Epoch
observers (the decision cache in the collectives dispatch layer) combine
the epoch with :meth:`PolicyRuntime.chain_fingerprint` in their keys.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Callable, Deque, Dict, Iterable, List, Optional, Sequence, Tuple

from . import faults as _faults
from .context import CTX_TYPES, PolicyContextValues
from .jit import compile_program
from .maps import BpfMap, MapError, MapRegistry, RingView
from .program import Program
from .verifier import VerifierError, verify_with_info
from .vm import VM
from ..device import require_cuda

_ZERO8 = bytes(8)

# sections whose chains compose first-non-deferring-wins / last-writer-wins
_FIRST_WINS_SECTIONS = ("tuner",)
_LAST_WRITER_SECTIONS = ("env",)


def _output_offsets(section: str) -> Tuple[int, ...]:
    """Byte offsets of the writable (output) ctx fields for ``section``."""
    ctx_type = CTX_TYPES[section]
    return tuple(f.offset for f in ctx_type.fields.values() if f.writable)


def _output_span(section: str) -> Optional[Tuple[int, int]]:
    """``(lo, hi)`` byte range covering the output fields when they are
    contiguous (every current ctx type lays outputs out at the tail), so
    defer detection is a single slice compare; None forces the per-field
    fallback."""
    offs = sorted(_output_offsets(section))
    if offs and offs == list(range(offs[0], offs[-1] + 8, 8)):
        return offs[0], offs[-1] + 8
    return None


@dataclasses.dataclass
class LoadedProgram:
    program: Program
    fn: Callable[[bytearray], int]      # JIT'd closure
    epoch: int
    verify_ms: float
    jit_ms: float
    loaded_at: float

    @property
    def name(self) -> str:
        return self.program.name

    @property
    def section(self) -> str:
        return self.program.section


@dataclasses.dataclass
class RuntimeStats:
    loads: int = 0
    reloads: int = 0
    replaces: int = 0
    bundles: int = 0
    rejected: int = 0
    invocations: int = 0
    swap_ns_last: int = 0
    # fault containment: contained runtime faults attributed to links,
    # links tripped to quarantined, load-time tier compile/lowering
    # failures (a subset of `rejected`), and contained T3 flush failures
    link_faults: int = 0
    quarantines: int = 0
    compile_failures: int = 0
    flush_failures: int = 0


@dataclasses.dataclass
class BreakerConfig:
    """Per-link circuit breaker knobs.

    A link records contained runtime faults (policy exceptions swallowed
    by its chain, invalid decisions attributed by the dispatcher); when
    ``threshold`` faults land within the last ``window`` runtime
    invocations, the link trips to **quarantined**: it stays in its
    chain's link tuple (introspection keeps working) but is skipped by
    the fused closure, with an epoch/fingerprint bump so decision caches
    stay coherent.  ``link.reset()`` rearms it."""
    window: int = 64
    threshold: int = 4
    enabled: bool = True


class LinkError(Exception):
    """Misuse of a PolicyLink (detached twice, replaced after detach, ...)."""


class PolicyLink:
    """First-class handle on one program's attachment to one hook chain.

    The link outlives program swaps: ``replace()`` verifies the new program
    and CASes it into the chain at the link's position (old program keeps
    running if verification rejects the new one).  ``detach()`` removes the
    link from its chain; a detached link is dead and raises on further use.
    """

    __slots__ = ("_runtime", "link_id", "section", "priority", "flags",
                 "_loaded", "_attached", "_quarantined", "faults",
                 "_fault_marks", "last_fault")

    def __init__(self, runtime: "PolicyRuntime", link_id: int, section: str,
                 priority: int, flags: int, loaded: LoadedProgram):
        self._runtime = runtime
        self.link_id = link_id
        self.section = section
        self.priority = priority
        self.flags = flags
        self._loaded = loaded
        self._attached = True
        # circuit-breaker state: lifetime fault count, the invocation
        # marks inside the sliding window, and the last fault's repr
        self._quarantined = False
        self.faults = 0
        self._fault_marks: Deque[int] = collections.deque()
        self.last_fault: Optional[str] = None

    # ---- introspection ---------------------------------------------------
    @property
    def is_attached(self) -> bool:
        return self._attached

    @property
    def is_quarantined(self) -> bool:
        return self._quarantined

    @property
    def state(self) -> str:
        if not self._attached:
            return "detached"
        return "quarantined" if self._quarantined else "attached"

    @property
    def loaded(self) -> LoadedProgram:
        return self._loaded

    @property
    def program(self) -> Program:
        return self._loaded.program

    @property
    def name(self) -> str:
        return self._loaded.name

    @property
    def fn(self) -> Callable[[bytearray], int]:
        return self._loaded.fn

    def __repr__(self) -> str:
        return (f"PolicyLink(#{self.link_id} {self.section}:{self.name} "
                f"prio={self.priority} {self.state})")

    def reset(self) -> None:
        """Clear the fault counters and — if quarantined — rejoin the
        chain (epoch bump, so decision caches resync)."""
        self._runtime._reset_link(self)

    # ---- lifecycle -------------------------------------------------------
    def detach(self) -> None:
        """Remove this link from its chain (one epoch bump)."""
        self._runtime._detach_link(self)

    def replace(self, program: Program) -> LoadedProgram:
        """Verify-then-CAS ``program`` into this link's chain slot.

        The old program keeps running until the new one has verified and
        JIT'd; ANY load-time failure — VerifierError or a tier
        compile/lowering error — propagates with the chain untouched
        (and no epoch bump).  Priority and chain position are
        preserved."""
        return self._runtime._replace_link(self, program)


@dataclasses.dataclass(frozen=True)
class _Chain:
    """Immutable published state of one hook's chain.

    Readers grab the whole object in one reference read; mutators build a
    fresh one and publish it with a single assignment.  ``fn`` is the bare
    fused closure (depth-1 collapses to the program's JIT'd function — the
    PR-1 fast path); ``counted_fn`` wraps it with invocation accounting for
    raw-closure (``invoke_fn``) callers, while ``invoke()`` counts inline."""
    links: Tuple[PolicyLink, ...]
    fn: Optional[Callable[[bytearray], Optional[int]]]
    counted_fn: Optional[Callable[[bytearray], Optional[int]]]
    fingerprint: int


_EMPTY_CHAIN = _Chain(links=(), fn=None, counted_fn=None, fingerprint=0)


class PolicyRuntime:
    """One runtime per process, holding maps + per-section link chains.

    ``tier`` selects the execution tier every loaded program runs on:

      * ``"cuda"``   — the hand-written CUDA policy kernel on the card
        (:mod:`repro_torch.core.cudac`), the default.  Without a CUDA
        device the runtime refuses to construct; it never quietly runs
        on the CPU.
      * ``"cuda32"`` — the same kernel in the pair form (every u64 as a
        ``[lo, hi]`` uint32 pair, :mod:`repro_torch.core.pair`; no
        ``lru_hash`` maps), also on the card
      * ``"torch"``  — the kernel's plain PyTorch version
        (:mod:`repro_torch.core.torchc`) on the CPU
      * ``"interp"`` — reference interpreter (differential ground truth)
      * ``"jit"``    — specializing host JIT (v2 codegen,
        :mod:`repro_torch.core.jit`) on the CPU
      * ``"native"`` — machine code through the system C toolchain
        (:mod:`repro_torch.core.cc`) on the CPU; without a toolchain it
        runs the ``jit`` closure instead, as in the reference (the
        closure's ``__bpf_codegen__`` says which ran)
      * ``"auto"``   — resolved at construction to ``"native"`` when
        :func:`~repro_torch.core.cc.have_cc` holds, else ``"jit"``;
        :attr:`tier` holds the resolved name

    ``cuda``, ``cuda32`` and ``torch`` run behind a device-resident
    :class:`~repro_torch.core.bridge.DeviceBridge`: map uploads are
    version-gated, only statically-written maps sync back per call, and
    the runtime flushes the bridge at every T3 boundary (detach /
    ``link.replace()`` / bundle reload) so host maps stay the
    cross-plugin source of truth exactly when attachment changes hands.

    All tiers reuse ONE verifier pass: the load path verifies once and
    hands the cfg / loop_bounds / max_steps artifacts to whichever
    compiler the tier selects.  ``use_interpreter=True`` is the legacy
    spelling of ``tier="interp"``."""

    TIERS = ("cuda", "cuda32", "torch", "interp", "jit", "native")

    def __init__(self, *, use_interpreter: bool = False,
                 tier: Optional[str] = None,
                 bridge_sync: str = "step",
                 bridge_shards: int = 1,
                 printk_log_max: int = 4096,
                 breaker: Optional[BreakerConfig] = None):
        if tier is None:
            tier = "interp" if use_interpreter else "cuda"
        if tier == "auto":
            # fastest available host tier: machine code when the box has
            # a toolchain, else the v2 JIT closure
            from .cc import have_cc
            tier = "native" if have_cc() else "jit"
        if tier not in self.TIERS:
            raise ValueError(f"unknown tier {tier!r}; valid tiers: "
                             f"{', '.join(self.TIERS)}")
        if bridge_sync not in ("step", "deferred"):
            raise ValueError(f"unknown bridge_sync {bridge_sync!r}; "
                             "use 'step' or 'deferred'")
        if bridge_shards < 1:
            raise ValueError(f"bridge_shards must be >= 1, "
                             f"got {bridge_shards}")
        if bridge_shards > 1 and bridge_sync != "deferred":
            raise ValueError("bridge_shards > 1 (mesh mode) requires "
                             "bridge_sync='deferred': per-shard deltas "
                             "merge at flush boundaries, not per call")
        if tier in ("cuda", "cuda32"):
            require_cuda(f"PolicyRuntime(tier={tier!r})")
        self.tier = tier
        # in-graph tiers: when kernel-written maps sync back to host maps
        # ("step" = after every call; "deferred" = at flush/T3 boundaries)
        self.bridge_sync = bridge_sync
        # in-graph tiers: device-resident map shards per bridge (mesh
        # mode — one per device/rank, reconciled by the shard merge)
        self.bridge_shards = bridge_shards
        self.maps = MapRegistry()
        self._chains: Dict[str, _Chain] = {s: _EMPTY_CHAIN for s in CTX_TYPES}
        self._epoch = 0
        self._next_link_id = 1
        self._load_lock = threading.Lock()
        self.stats = RuntimeStats()
        self.breaker = breaker if breaker is not None else BreakerConfig()
        # per-section one-slot cell recording which link decided last in
        # a multi-link first-wins chain (fault attribution); depth-1
        # chains don't write it — the single active link is the decider
        self._deciders: Dict[str, List[Optional[PolicyLink]]] = {
            s: [None] for s in CTX_TYPES}
        self.use_interpreter = tier == "interp"
        # bounded printk log — chatty policies on long-running jobs must
        # not leak memory through trace_printk (same leak class the
        # decision log fixed in PR 1).  Storage is the observability
        # plane's ringbuf in overwrite mode (oldest value ages out, the
        # eviction is counted in `drops`), decoded through RingView so
        # the historical append/iter surface is unchanged
        self._printk_log = RingView(
            printk_log_max, 8,
            lambda v: (int(v) & 0xFFFFFFFFFFFFFFFF).to_bytes(8, "little"),
            lambda b: int.from_bytes(b, "little"),
            name="printk_log")
        # flight recorder registered by repro.obs (duck-typed: anything
        # with a counters() dict), folded into health()
        self._recorder = None
        # the link created/replaced by the legacy load()/reload() API, per
        # section — keeps single-program call sites working unchanged
        self._legacy: Dict[str, Optional[PolicyLink]] = {
            s: None for s in CTX_TYPES}

    # ---- section validation ---------------------------------------------
    @staticmethod
    def sections() -> List[str]:
        """Valid hook section names (tuner / profiler / net / env)."""
        return list(CTX_TYPES)

    def _check_section(self, section: str) -> str:
        if section not in self._chains:
            raise KeyError(
                f"unknown section {section!r}; valid sections: "
                f"{', '.join(CTX_TYPES)}")
        return section

    # ---- link API (the redesigned surface) -------------------------------
    def attach(self, program: Program, *, priority: int = 0,
               flags: int = 0) -> PolicyLink:
        """Verify + JIT ``program`` and append a link to its section chain.

        Links order by ascending ``priority`` (attach order breaks ties);
        lower numbers take precedence.  Raises VerifierError on rejection
        (chain untouched)."""
        with self._load_lock:
            lp = self._prepare(program)
            link = self._new_link(lp, priority, flags)
            self._publish({program.section: self._chain_links(
                program.section) + [link]})
            self.stats.loads += 1
            return link

    def load_bundle(self, programs: Sequence[Program],
                    priorities: Optional[Sequence[int]] = None
                    ) -> List[PolicyLink]:
        """Transactionally replace the chains of every section in ``programs``.

        All programs are verified — and their map declarations shape-checked
        against the registry AND against each other — before anything is
        mutated; any rejection (VerifierError, MapError, or a tier
        compile/lowering failure in phase 2) propagates with every
        previous chain fully attached, the epoch untouched, and no
        chains swapped.  On success all affected chains swap under ONE
        epoch bump — multi-policy updates are atomic end-to-end.

        ``priorities`` parallels ``programs`` (default: bundle order, i.e.
        earlier programs take precedence within their section)."""
        programs = list(programs)
        if not programs:
            return []
        if priorities is None:
            priorities = list(range(len(programs)))
        if len(priorities) != len(programs):
            raise ValueError("priorities must parallel programs")
        with self._load_lock:
            # phase 1 — verify everything + dry-run map shapes (against the
            # registry and against same-name declarations elsewhere in the
            # bundle): no side effects until the whole bundle is known good
            vinfos = []
            bundle_decls: Dict[str, tuple] = {}
            for p in programs:
                try:
                    vinfos.append(verify_with_info(p))
                except VerifierError:
                    self.stats.rejected += 1
                    raise
                for d in p.maps:
                    self.maps.validate(d.name, d.kind, key_size=d.key_size,
                                       value_size=d.value_size,
                                       max_entries=d.max_entries)
                    shape = self.maps._shape_of(d.kind, d.key_size,
                                                d.value_size, d.max_entries)
                    seen = bundle_decls.setdefault(d.name, shape)
                    if seen != shape:
                        raise MapError(
                            f"map {d.name}: bundle programs declare it "
                            f"with different shapes")
            # phase 2 — resolve + JIT, reusing the phase-1 verifier info.
            # Verification cannot reject here, but tier compile/lowering
            # still can — and it happens before phase 3 touches any
            # chain, so a mid-bundle compile failure leaves every
            # previous chain attached and the epoch unbumped (maps
            # created for earlier bundle members persist: map creation
            # is idempotent and shape-checked in phase 1)
            links: List[PolicyLink] = []
            new_chains: Dict[str, List[PolicyLink]] = {}
            for p, prio, vinfo in zip(programs, priorities, vinfos):
                lp = self._prepare(p, vinfo=vinfo)
                link = self._new_link(lp, prio, 0)
                links.append(link)
                new_chains.setdefault(p.section, []).append(link)
            # phase 3 — the swap: every affected section's previous chain is
            # replaced wholesale, one epoch bump total
            t0 = time.perf_counter_ns()
            for section, chain_links in new_chains.items():
                for old in self._chains[section].links:
                    old._attached = False
                    self._flush_bridge(old._loaded)
                self._legacy[section] = None
            self._publish(new_chains)
            self.stats.swap_ns_last = time.perf_counter_ns() - t0
            self.stats.bundles += 1
            self.stats.loads += len(links)
            return links

    def chain(self, section: str) -> Tuple[PolicyLink, ...]:
        """The attached links for ``section`` in execution-precedence order."""
        return self._chains[self._check_section(section)].links

    def chain_fingerprint(self, section: str) -> int:
        """Stable identity of the current chain composition — joins the
        epoch in decision-cache keys so chain changes can never alias."""
        return self._chains[self._check_section(section)].fingerprint

    # ---- legacy single-program shims -------------------------------------
    def load(self, program: Program) -> LoadedProgram:
        """Verify + JIT + attach (single-slot semantics: a second ``load``
        on the same section replaces the first).  Raises VerifierError on
        rejection.  New code should prefer :meth:`attach`."""
        with self._load_lock:
            lp = self._swap_legacy(program)
            self.stats.loads += 1
            return lp

    def reload(self, program: Program) -> LoadedProgram:
        """Atomic hot-reload of the legacy slot at ``program.section``.

        If verification fails the old policy keeps running (never an
        unverified state)."""
        with self._load_lock:
            # a VerifierError propagates (counted once, in _prepare) and
            # leaves the old policy attached
            t_swap = [0]
            lp = self._swap_legacy(program, t_swap)
            self.stats.swap_ns_last = t_swap[0]
            self.stats.reloads += 1
            return lp

    def try_reload(self, program: Program) -> Optional[Exception]:
        """Reload; on rejection return the error instead of raising.

        Covers every load-time rejection class — verification AND tier
        compile/lowering failures — so supervisory reload loops degrade
        to "old policy keeps running" on any of them."""
        try:
            self.reload(program)
            return None
        except Exception as e:
            return e

    def detach(self, section: str) -> None:
        """Detach *every* link on ``section`` (one epoch bump).

        Raises KeyError listing valid sections on an unknown name.  For
        surgical removal detach the individual :class:`PolicyLink`."""
        self._check_section(section)
        with self._load_lock:
            for link in self._chains[section].links:
                link._attached = False
                self._flush_bridge(link._loaded)
            self._legacy[section] = None
            self._publish({section: []})

    def attached(self, section: str) -> Optional[LoadedProgram]:
        """Highest-precedence ACTIVE program on ``section`` (None if the
        chain is empty or fully quarantined)."""
        for link in self._chains[self._check_section(section)].links:
            if not link._quarantined:
                return link._loaded
        return None

    def is_attached(self, section: str) -> bool:
        """True iff the section has at least one ACTIVE (non-quarantined)
        link — i.e. ``invoke()`` would run something."""
        return self._chains[self._check_section(section)].fn is not None

    # ---- fault containment -----------------------------------------------
    def last_decider(self, section: str) -> Optional[PolicyLink]:
        """The link whose decision a multi-link first-wins chain last
        returned (None for depth-1 chains / all-deferred runs)."""
        return self._deciders[self._check_section(section)][0]

    def record_fault(self, link: Optional[PolicyLink], exc=None, *,
                     section: Optional[str] = None) -> Optional[PolicyLink]:
        """Count one contained runtime fault against ``link`` and trip its
        breaker if the sliding window fills.

        With ``link=None`` the fault is attributed to ``section``'s
        highest-precedence active link (the dispatcher's depth-1 case —
        the only link that could have produced the fault).  Returns the
        link charged, or None when nothing is attached."""
        if link is None and section is not None:
            for cand in self._chains[self._check_section(section)].links:
                if not cand._quarantined:
                    link = cand
                    break
        if link is None:
            return None
        self.stats.link_faults += 1
        link.faults += 1
        if exc is not None:
            link.last_fault = repr(exc)
        br = self.breaker
        if not br.enabled or link._quarantined or not link._attached:
            return link
        # fault clock = runtime invocations, so the window means "faults
        # per recent chain executions", not wall time
        now = self.stats.invocations
        marks = link._fault_marks
        marks.append(now)
        while marks and now - marks[0] > br.window:
            marks.popleft()
        if len(marks) >= br.threshold:
            self._quarantine(link)
        return link

    def _quarantine(self, link: PolicyLink) -> None:
        with self._load_lock:
            if link._quarantined or not link._attached:
                return
            link._quarantined = True
            # T3 boundary: the link's bridge state reaches host maps
            # before its program stops running in the chain
            self._flush_bridge(link._loaded)
            self.stats.quarantines += 1
            self._publish({link.section: self._chain_links(link.section)})

    def _reset_link(self, link: PolicyLink) -> None:
        with self._load_lock:
            link.faults = 0
            link._fault_marks.clear()
            link.last_fault = None
            if not link._quarantined:
                return
            link._quarantined = False
            if link._attached:
                self._publish({link.section: self._chain_links(link.section)})

    def health(self) -> Dict[str, object]:
        """Operator introspection: per-link breaker state for every
        section with links, runtime-wide fault totals, aggregated
        device-bridge counters, and the observability plane's loss
        accounting (printk ring + registered flight recorder) — one
        structured dict for the whole runtime."""
        sections: Dict[str, list] = {}
        total = 0
        quarantined = 0
        for s, ch in self._chains.items():
            rows = []
            for l in ch.links:
                total += l.faults
                quarantined += 1 if l._quarantined else 0
                rows.append({"link_id": l.link_id, "name": l.name,
                             "priority": l.priority, "state": l.state,
                             "faults": l.faults,
                             "last_fault": l.last_fault})
            if rows:
                sections[s] = rows
        return {"epoch": self._epoch, "tier": self.tier,
                "sections": sections, "faults": total,
                "quarantined": quarantined,
                "breaker": dataclasses.asdict(self.breaker),
                "stats": dataclasses.asdict(self.stats),
                "bridge": self.bridge_stats(),
                "observability": self._obs_health()}

    def bridge_stats(self) -> Dict[str, int]:
        """Device-bridge counters summed across every attached link
        (host-tier closures contribute nothing).  Keys mirror
        :class:`~repro_torch.core.bridge.BridgeStats` plus ``n_bridges``."""
        agg: Dict[str, int] = {"n_bridges": 0}
        for ch in self._chains.values():
            for link in ch.links:
                st = getattr(link._loaded.fn, "stats", None)
                if not dataclasses.is_dataclass(st):
                    continue
                agg["n_bridges"] += 1
                for k, v in dataclasses.asdict(st).items():
                    agg[k] = agg.get(k, 0) + v
        return agg

    def _obs_health(self) -> Dict[str, object]:
        obs: Dict[str, object] = {
            "printk": {"stored": len(self._printk_log),
                       "capacity": self._printk_log.maxlen,
                       "drops": self._printk_log.drops},
        }
        rec = self._recorder
        if rec is not None:
            obs["recorder"] = rec.counters()
        return obs

    def attach_recorder(self, recorder) -> None:
        """Publish a flight recorder (anything with ``counters()``) on
        the runtime so :meth:`health` folds its drop/overflow accounting
        into the observability section.  ``None`` unregisters."""
        self._recorder = recorder

    def flush_bridges(self, section: Optional[str] = None) -> None:
        """Flush device-resident bridge state of every attached link (one
        section, or all) back to host maps — the same contained writeback
        the runtime performs at T3 attachment boundaries, exposed for
        host-side consumers (flight-recorder drains, exporters) that need
        in-graph map writes visible between boundaries.  No-op for
        host-tier links; failures are counted, never raised."""
        names = [self._check_section(section)] if section is not None \
            else list(self._chains)
        for s in names:
            for link in self._chains[s].links:
                self._flush_bridge(link._loaded)

    # ---- mutation internals (call with _load_lock held) -------------------
    def _flush_bridge(self, lp: Optional[LoadedProgram]) -> None:
        """Write a device-resident bridge's map state back to the host
        maps before its program leaves a chain.  The T3 contract: at
        every attachment boundary (detach / replace / bundle reload) the
        host maps are the source of truth the successor program — on any
        tier — starts from.  No-op for host-tier closures.

        A failing flush is contained (counted, not raised): an attachment
        change must never abort on a sync fault — the bridge keeps its
        device-dirty marks, so a later flush or healthy call retries the
        writeback."""
        if lp is None:
            return
        flush = getattr(lp.fn, "flush", None)
        if callable(flush):
            try:
                flush()
            except Exception:
                self.stats.flush_failures += 1

    def _new_link(self, lp: LoadedProgram, priority: int,
                  flags: int) -> PolicyLink:
        link = PolicyLink(self, self._next_link_id, lp.section, priority,
                          flags, lp)
        self._next_link_id += 1
        return link

    def _chain_links(self, section: str) -> List[PolicyLink]:
        return list(self._chains[section].links)

    def _swap_legacy(self, program: Program,
                     t_swap: Optional[List[int]] = None) -> LoadedProgram:
        lp = self._prepare(program)
        section = program.section
        legacy = self._legacy[section]
        t0 = time.perf_counter_ns()
        if legacy is not None and legacy._attached:
            self._flush_bridge(legacy._loaded)
            legacy._loaded = lp
            self._publish({section: self._chain_links(section)})
        else:
            link = self._new_link(lp, 0, 0)
            self._legacy[section] = link
            self._publish({section: self._chain_links(section) + [link]})
        if t_swap is not None:
            t_swap[0] = time.perf_counter_ns() - t0
        return lp

    def _detach_link(self, link: PolicyLink) -> None:
        with self._load_lock:
            if not link._attached:
                raise LinkError(f"{link!r} is already detached")
            link._attached = False
            self._flush_bridge(link._loaded)
            if self._legacy[link.section] is link:
                self._legacy[link.section] = None
            remaining = [l for l in self._chains[link.section].links
                         if l is not link]
            self._publish({link.section: remaining})

    def _replace_link(self, link: PolicyLink,
                      program: Program) -> LoadedProgram:
        if program.section != link.section:
            raise LinkError(
                f"cannot replace {link.section!r} link with a "
                f"{program.section!r} program")
        with self._load_lock:
            if not link._attached:
                raise LinkError(f"{link!r} is detached; attach a new link")
            # verify-then-CAS: _prepare raises on rejection with the old
            # program still attached and the epoch untouched (a rejected
            # replacement also leaves the old bridge state device-resident)
            lp = self._prepare(program)
            self._flush_bridge(link._loaded)
            t0 = time.perf_counter_ns()
            link._loaded = lp
            self._publish({link.section: self._chain_links(link.section)})
            self.stats.swap_ns_last = time.perf_counter_ns() - t0
            self.stats.replaces += 1
            return lp

    def _publish(self, new_chains: Dict[str, List[PolicyLink]]) -> None:
        """Rebuild + publish the given chains, then bump the epoch once.

        Each chain is published by a single reference assignment (the CAS);
        the epoch bump comes second — same ordering as the seed runtime —
        so epoch observers never see a new epoch with an old chain."""
        for section, links in new_chains.items():
            links = sorted(links, key=lambda l: (l.priority, l.link_id))
            fn = self._fuse(section, links)
            self._chains[section] = _Chain(
                links=tuple(links),
                fn=fn,
                counted_fn=None if fn is None else self._counted(fn),
                fingerprint=self._fingerprint(links))
        self._epoch += 1

    @staticmethod
    def _fingerprint(links: List[PolicyLink]) -> int:
        if not links:
            return 0
        # the quarantine flag joins the identity: tripping/resetting a
        # breaker changes what the fused chain executes, so decision
        # caches keyed on (epoch, fingerprint) must never alias across it
        return hash(tuple((l.link_id, l.priority, l.name, id(l._loaded),
                           l._quarantined)
                          for l in links)) & 0x7FFFFFFFFFFFFFFF

    # ---- chain fusion ----------------------------------------------------
    def _fuse(self, section: str,
              links: List[PolicyLink]) -> Optional[Callable]:
        """Pre-fuse the chain into one bare closure ``fn(buf) -> ret``.

        Quarantined links stay in the link tuple but are excluded here.
        Depth-1 collapses to the program's JIT'd closure itself — zero
        wrapper frames, so the PR-1 fast path survives chain-aware
        dispatch exactly (its exceptions are contained one level up, by
        the dispatcher's guarded decide).  Multi-link chains guard each
        link: a link that throws is treated as having deferred — its
        partial outputs are discarded, the fault is recorded against
        exactly that link (breaker attribution), and the next link runs.
        Invocation counting lives in ``invoke()`` and in the
        ``counted_fn`` wrapper handed out by ``invoke_fn()``."""
        active = [l for l in links if not l._quarantined]
        if not active:
            return None
        if len(active) == 1:
            return active[0]._loaded.fn
        pairs = [(l, l._loaded.fn) for l in active]
        record = self.record_fault
        if section in _FIRST_WINS_SECTIONS:
            # "link deferred" means "link left every output zero", so the
            # outputs are zeroed at chain entry — a reused ctx with stale
            # outputs from a previous decision must not masquerade as the
            # first link's decision
            decider = self._deciders[section]
            span = _output_span(section)
            if span is not None:
                lo, hi = span
                zeros = bytes(hi - lo)

                def chain_first_wins(buf: bytearray) -> int:
                    buf[lo:hi] = zeros
                    decider[0] = None
                    ret = 0
                    for link, fn in pairs:
                        try:
                            ret = fn(buf)
                        except Exception as e:
                            # contained: a throwing link defers — discard
                            # its partial outputs, run the next link
                            record(link, e)
                            buf[lo:hi] = zeros
                            continue
                        if buf[lo:hi] != zeros:
                            decider[0] = link
                            return ret      # first non-deferring decision
                    return ret              # every program deferred
                return chain_first_wins
            offs = _output_offsets(section)

            def chain_first_wins_sparse(buf: bytearray) -> int:
                for off in offs:
                    buf[off:off + 8] = _ZERO8
                decider[0] = None
                ret = 0
                for link, fn in pairs:
                    try:
                        ret = fn(buf)
                    except Exception as e:
                        record(link, e)
                        for off in offs:
                            buf[off:off + 8] = _ZERO8
                        continue
                    for off in offs:
                        if buf[off:off + 8] != _ZERO8:
                            decider[0] = link
                            return ret
                return ret
            return chain_first_wins_sparse
        run_order = list(reversed(pairs)) \
            if section in _LAST_WRITER_SECTIONS else pairs

        def chain_all(buf: bytearray) -> int:
            ret = 0
            for link, fn in run_order:
                try:
                    ret = fn(buf)
                except Exception as e:
                    # invoke-all hooks: one faulty observer must not
                    # starve the others (or the caller)
                    record(link, e)
            return ret
        return chain_all

    def _counted(self, fn: Callable) -> Callable:
        """Invocation-accounting wrapper for raw-closure callers, so
        ``invoke_fn()`` users land in ``stats.invocations`` like
        ``invoke()`` callers do."""
        stats = self.stats

        def counted(buf: bytearray) -> int:
            stats.invocations += 1
            return fn(buf)
        return counted

    # ---- loading ---------------------------------------------------------
    def _prepare(self, program: Program, vinfo=None) -> LoadedProgram:
        t0 = time.perf_counter()
        if vinfo is None:
            try:
                vinfo = verify_with_info(program)
            except VerifierError:
                self.stats.rejected += 1
                raise
        t1 = time.perf_counter()
        resolved = self._resolve_maps(program)
        try:
            _faults.fire("compile", self.tier)
            if self.tier == "interp":
                # fuel: the verifier's proven dynamic-step bound (plus
                # slack for helper-internal work) as runtime
                # defense-in-depth; the proven bound always wins —
                # clamping below it would fault verified programs on the
                # interpreter tier only
                fuel = max(4 * vinfo.max_steps, 4096)
                vm = VM(program.insns, resolved,
                        printk=self._printk_log.append, fuel=fuel,
                        subprogs=program.subprogs)
                fn = vm.run
            elif self.tier == "native":
                # machine code via the system toolchain; same verifier
                # artifacts, third consumer.  Hosts without a compiler
                # fall back to the v2 JIT closure — the tier degrades,
                # it never rejects a program the JIT would accept
                from .cc import compile_native, have_cc
                if have_cc():
                    fn = compile_native(
                        program, resolved, vinfo,
                        printk=self._printk_log.append)
                else:
                    fn = compile_program(program, resolved,
                                         printk=self._printk_log.append,
                                         info=vinfo)
            elif self.tier == "jit":
                # the verifier's region analysis feeds the specializing
                # (v2) code generator — one static pass pays for both
                # safety and speed
                fn = compile_program(program, resolved,
                                     printk=self._printk_log.append,
                                     info=vinfo)
            else:
                # the policy kernel (or its plain version) behind the
                # device-resident bridge; the verifier's cfg/loop_bounds/
                # region artifacts are reused, never recomputed, and a
                # kernel that does not build rejects the load
                from .bridge import compile_host
                fn = compile_host(program, resolved, vinfo, tier=self.tier,
                                  sync=self.bridge_sync,
                                  n_shards=self.bridge_shards)
        except Exception:
            # ANY tier compile/lowering failure is a load-time rejection:
            # every caller (attach / replace / load_bundle / reload)
            # mutates chains only after _prepare returns, so the old
            # chain keeps running and the epoch stays untouched — the
            # same atomicity contract as a VerifierError
            self.stats.rejected += 1
            self.stats.compile_failures += 1
            raise
        t2 = time.perf_counter()
        return LoadedProgram(program=program, fn=fn, epoch=self._epoch + 1,
                             verify_ms=(t1 - t0) * 1e3, jit_ms=(t2 - t1) * 1e3,
                             loaded_at=time.time())

    def _resolve_maps(self, program: Program) -> Dict[str, BpfMap]:
        out = {}
        for d in program.maps:
            out[d.name] = self.maps.create(
                d.name, d.kind, key_size=d.key_size,
                value_size=d.value_size, max_entries=d.max_entries)
            if getattr(d, "shared", False):
                # the paper's cross-plugin map: pin it so other programs
                # (and host-side tooling) find it by name
                self.maps.pin(d.name)
        return out

    # ---- invocation --------------------------------------------------------
    @property
    def epoch(self) -> int:
        return self._epoch

    def invoke(self, section: str, ctx: PolicyContextValues) -> Optional[int]:
        """Run the fused chain for ``section``; None if nothing attached.

        Multi-link first-wins chains zero the ctx output fields at entry
        (a reused ctx must not leak a previous decision into defer
        detection); depth-1 chains run the program on the ctx as-is."""
        try:
            fn = self._chains[section].fn   # atomic read of published chain
        except KeyError:
            self._check_section(section)    # raises with valid sections
            raise
        if fn is None:
            return None
        self.stats.invocations += 1
        return fn(ctx.buf)

    def invoke_fn(self, section: str
                  ) -> Optional[Callable[[bytearray], int]]:
        """Grab the fused chain closure (hot-path callers cache nothing
        across calls: each call re-reads the published chain, so hot-reload
        takes effect on the next call — T3 semantics).  The returned
        closure counts into ``stats.invocations`` like ``invoke()`` does."""
        return self._chains[self._check_section(section)].counted_fn

    # ---- convenience -------------------------------------------------------
    def printk_log(self) -> List[int]:
        return list(self._printk_log)


_GLOBAL_RUNTIME: Optional[PolicyRuntime] = None
_GLOBAL_LOCK = threading.Lock()


def global_runtime() -> PolicyRuntime:
    global _GLOBAL_RUNTIME
    with _GLOBAL_LOCK:
        if _GLOBAL_RUNTIME is None:
            _GLOBAL_RUNTIME = PolicyRuntime()
        return _GLOBAL_RUNTIME


def reset_global_runtime() -> None:
    global _GLOBAL_RUNTIME
    with _GLOBAL_LOCK:
        _GLOBAL_RUNTIME = None
