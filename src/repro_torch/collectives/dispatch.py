"""Policy-driven collective dispatch — the getCollInfo() integration point.

Every collective the framework emits calls into :class:`CollectiveDispatcher`,
which mirrors NCCL's tuner-plugin flow:

  1. build a ``policy_context`` (collective type, message bytes, rank count,
     communicator id, axis kind, dtype, max channels)
  2. invoke the attached verified tuner chain (host tier; first
     non-deferring link wins) — falling back to the framework default
     (DEFAULT algorithm, like NCCL defaulting to NVLS) when no policy is
     attached or every policy defers
  3. translate the decision through a tuner-v5-style cost table: the
     policy's choice zeroes its (algo, proto) cost; infeasible combinations
     keep sentinel cost so dispatch falls back gracefully
  4. clamp channels to the framework's max (NCCL passes maxChannels the
     tuner must respect)
  5. emit the chosen algorithm's ops over ``torch.distributed``
     (:mod:`repro_torch.collectives.algorithms`)

Decisions happen per call, on the host side of the launch (the
information getCollInfo sees per call); the collective entry points
(:meth:`CollectiveDispatcher.all_reduce` and friends) take the tensor,
the axis name and the process group.  The axis name stays a string, so
the communicator id (``_comm_id(axis_name, n)``) and every decision
equal the reference's; ``n`` is the group's size.  The dispatcher
records a decision log; the policy *epoch* is exposed so callers can
key their own caches on it (§T3: in-flight work finishes on the old
policy).

Two-layer fast path
-------------------
1. **Execution layer** — each ``decide()`` invokes the attached chain on
   the runtime's tier (by default the CUDA policy kernel, see
   :mod:`repro_torch.core.cudac`).
2. **Dispatch layer** — repeat decisions are memoized.  When every program
   in the attached tuner chain is *pure* (calls no helpers: no map state,
   no clock, no randomness — statically determined from its bytecode), the
   decision is a function of the ctx inputs only, so it is cached keyed on
   ``(epoch, chain_fingerprint, coll, size, n_ranks, axis_kind,
   dtype_bytes, comm_id)`` plus
   the config knobs and the mesh topology pair (``set_topology``).  The **epoch** in the key is what preserves the
   paper's T3 hot-reload semantics: every load/reload/detach bumps the
   runtime epoch, so the very next ``decide()`` after a swap *completes*
   misses the cache and re-runs the new policy.  The guarantee is exactly
   the paper's: a ``decide()`` racing the swap itself may still observe
   the old policy (T3's in-flight allowance — the same holds for a call
   that read the old function pointer just before the CAS); once the
   swap's epoch bump is visible, no cached fast path can serve a stale
   policy's decision.  Stateful policies (any helper call) bypass
   the cache entirely and run on every dispatch, as before.  Cost-model
   rows are memoized independently in :class:`CostModel`, and the
   communicator hash is ``lru_cache``'d.

The decision log is a bounded ring buffer
(``DispatchConfig.decision_log_max``, default 4096) so long-running
serving/training jobs don't leak memory through an ever-growing list.

The net-plugin hook (§5.3) interposes here too: when a net program is
attached, each dispatch invokes it with (op, bytes, peer) — the data-plane
accounting path.  Net/profiler hooks and the decision log run on cache
hits as well: memoization elides the policy invocation and cost-table
translation, never the observable side channels.

Fault containment (runtime guards)
----------------------------------
With ``DispatchConfig.enable_runtime_guards`` (the default) every
``decide()`` is sandboxed: inputs are sanitized (NaN/inf/negative
telemetry is clamped, never fed to policies), any exception escaping the
policy chain is caught and converted into the cost-model default
decision, and out-of-domain decisions (algorithm/protocol outside the
enum, channels overflowing u32) are counted as faults and charged to the
deciding link's circuit breaker (see ``core.runtime``).  Faulted
decisions are never inserted into the decision cache.  When the
dispatcher-level sliding fault window fills
(``safe_mode_threshold`` faults within ``safe_mode_window`` decisions)
the dispatcher enters **safe mode**: tuner policies are skipped entirely
and dispatch runs pure cost-model defaults for ``safe_mode_cooldown``
decisions, then re-probes (half-open).  No fault ever reaches the
collective: the numeric result during a fault is identical to running
with policies detached.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import hashlib
import math
import struct
import threading
from time import perf_counter_ns as _ns
from typing import Callable, Deque, Dict, List, Optional, Tuple

import torch.autograd.profiler as _prof
import torch.distributed as dist

from ..core import faults as _faults
from ..core.context import (Algo, AxisKind, CollType, PROFILER_CONTEXT,
                            Proto, make_ctx)
from ..core.maps import RingView
from ..core.runtime import PolicyRuntime, global_runtime
from ..obs.trace import STORE as _spans
from . import algorithms as alg
from .cost_model import CostModel, HwProfile, TPU_V5E

SENTINEL_COST = 1e9
MAX_CHANNELS = 32


@dataclasses.dataclass
class Decision:
    coll: int
    algo: int
    proto: int
    channels: int
    size_bytes: int
    n_ranks: int
    axis_kind: int
    comm_id: int
    from_policy: bool

    def key(self) -> Tuple:
        return (self.coll, self.algo, self.proto, self.channels)


# decision-log record codec: 9 u64 slots, one Decision per ringbuf record
_DECISION_STRUCT = struct.Struct("<9Q")


def _encode_decision(d: "Decision") -> bytes:
    return _DECISION_STRUCT.pack(
        d.coll, d.algo, d.proto, d.channels, d.size_bytes, d.n_ranks,
        d.axis_kind, d.comm_id, 1 if d.from_policy else 0)


def _decode_decision(raw: bytes) -> "Decision":
    (coll, algo, proto, channels, size_bytes, n_ranks, axis_kind,
     comm_id, from_policy) = _DECISION_STRUCT.unpack(raw)
    return Decision(coll=coll, algo=algo, proto=proto, channels=channels,
                    size_bytes=size_bytes, n_ranks=n_ranks,
                    axis_kind=axis_kind, comm_id=comm_id,
                    from_policy=bool(from_policy))


@dataclasses.dataclass
class DispatchConfig:
    hw: HwProfile = TPU_V5E
    default_algo: int = Algo.DEFAULT
    default_proto: int = Proto.SIMPLE
    default_channels: int = 8
    max_channels: int = MAX_CHANNELS
    enable_net_hook: bool = True
    # ring-buffer capacity of the decision log (0 disables logging)
    decision_log_max: int = 4096
    # memoize decisions of pure (helper-free) tuner policies
    enable_decision_cache: bool = True
    # within-epoch entry cap; overflow evicts the OLDEST HALF (insertion
    # order), never the whole cache — a burst of distinct keys must not
    # trigger a periodic full-recompute storm on the hot entries
    decision_cache_max: int = 4096
    # --- fault containment (runtime guards) ---------------------------
    # sanitize inputs, catch policy exceptions, reject out-of-domain
    # decisions; a fault always degrades to the cost-model default
    enable_runtime_guards: bool = True
    # safe mode: >= threshold faults within the last `window` decisions
    # detaches ALL tuner policies for `cooldown` decisions, then re-probes
    safe_mode_threshold: int = 8
    safe_mode_window: int = 64
    safe_mode_cooldown: int = 512
    # --- mesh-scale telemetry -----------------------------------------
    # auto-run sync_telemetry() every N decisions (0 = manual only):
    # the all-gather merge step that reconciles per-device map shards
    # back into the pinned host maps
    telemetry_sync_every: int = 0


@dataclasses.dataclass
class FaultStats:
    """Dispatcher-level fault accounting (``dispatcher().fault_stats``)."""
    policy_exceptions: int = 0   # exceptions escaping a policy chain
    invalid_decisions: int = 0   # out-of-domain (algo/proto/channels)
    invalid_inputs: int = 0      # NaN/inf/negative telemetry sanitized
    safe_mode_entries: int = 0
    safe_mode_decisions: int = 0  # decisions served while in safe mode

    @property
    def total(self) -> int:
        """Faults that feed the safe-mode window (input sanitization is
        counted but does not trip safe mode — garbage in is a caller
        bug, not a policy fault)."""
        return self.policy_exceptions + self.invalid_decisions


@functools.lru_cache(maxsize=4096)
def _comm_id(axis_name: str, n: int) -> int:
    """Stable communicator hash (the paper derives one from the context
    pointer; we derive one from the axis identity).  Cached — axes recur
    on every dispatch and SHA1 is by far the most expensive part."""
    h = hashlib.sha1(f"{axis_name}:{n}".encode()).digest()
    return int.from_bytes(h[:4], "little") & 0x7FFFFFFF


def _algo_fn(coll: int, algo: int) -> Callable:
    """The emit table: ``(coll, algo)`` -> the algorithm that runs it."""
    if coll == CollType.ALL_REDUCE:
        return {
            Algo.DEFAULT: alg.allreduce_native,
            Algo.RING: alg.allreduce_ring,
            Algo.TREE: alg.allreduce_tree,
            Algo.BIDIR_RING: alg.allreduce_bidir_ring,
        }[algo]
    if coll == CollType.ALL_TO_ALL:
        return {
            Algo.DEFAULT: alg.all_to_all_native,
            Algo.RING: alg.all_to_all_chunked,
            Algo.TREE: alg.all_to_all_chunked,
            Algo.BIDIR_RING: alg.all_to_all_chunked,
        }[algo]
    if coll == CollType.REDUCE_SCATTER:
        if algo == Algo.DEFAULT:
            return alg.reduce_scatter_native
        return alg.reduce_scatter_ring
    if coll == CollType.ALL_GATHER:
        if algo == Algo.DEFAULT:
            return alg.all_gather_native
        return alg.all_gather_ring
    raise KeyError(f"no implementation for coll {coll} algo {algo}")


class CollectiveDispatcher:
    def __init__(self, runtime: Optional[PolicyRuntime] = None,
                 config: Optional[DispatchConfig] = None,
                 tier: Optional[str] = None):
        # tier="auto" resolves to the fastest available host tier
        # (native when a C toolchain is present, else the v2 JIT);
        # explicit runtime wins over tier; with neither, the process-wide
        # runtime (tier="cuda") decides
        if runtime is None and tier is not None:
            runtime = PolicyRuntime(tier=tier)
        self.runtime = runtime or global_runtime()
        self.config = config or DispatchConfig()
        self.cost_model = CostModel(self.config.hw)
        # bounded decision log on the observability plane's ringbuf
        # (overwrite mode: a full ring evicts the OLDEST decision, and
        # the eviction is counted in ``decisions.drops``).  RingView
        # keeps the deque surface the call sites grew up with —
        # append / len / [-1] / clear / maxlen — over 72-byte encoded
        # records, so the log's memory bound is exact, not amortized
        log_max = self.config.decision_log_max
        self.decisions = RingView(log_max, _DECISION_STRUCT.size,
                                  _encode_decision, _decode_decision,
                                  name="decision_log")
        self.net_calls = 0
        self.net_bytes = 0
        # Epoch-keyed decision memo, published as one immutable
        # *generation* tuple (epoch, chain_fingerprint, cacheable, dict)
        # so concurrent decide() calls read a consistent snapshot in a
        # single GIL-atomic attribute load.  A hot-reload epoch bump
        # racing a decide() can therefore never pair one epoch's purity
        # verdict with another epoch's fingerprint, and a stale in-flight
        # thread inserts into ITS generation's dict — unreachable from
        # any thread that has observed the swap.  The lock guards only
        # the (rare) resync and eviction paths, never the hit path.
        self._cache_lock = threading.Lock()
        self._cache_gen: Tuple[int, int, bool, Dict[Tuple, Decision]] = \
            (-1, 0, False, {})
        self.cache_hits = 0
        self.cache_misses = 0
        # fault containment state: monotone decision counter (the fault
        # clock, and the id of each decision's spans), sliding window of
        # recent fault marks, safe-mode latch
        self.fault_stats = FaultStats()
        self._decision_seq = 0
        self._fault_marks: Deque[int] = collections.deque()
        self._safe_mode = False
        self._safe_until = 0
        # mesh topology fed into every policy ctx (0 = unknown: policies
        # treat the mesh as one node); participates in the cache key
        self._n_nodes = 0
        self._ranks_per_node = 0
        # mesh-telemetry merge plumbing: registered sync callbacks
        # (multi-shard bridge flushes, in-graph state merges) plus the
        # auto-trigger bookkeeping
        self._mesh_syncs: List[Callable[[], object]] = []
        self._decisions_since_sync = 0
        self.telemetry_syncs = 0
        self._apply_env_plugin()

    # ------------------------------------------------------------------
    # mesh topology + sharded-telemetry merge
    # ------------------------------------------------------------------
    def set_topology(self, mesh=None, *, n_nodes: int = 0,
                     ranks_per_node: int = 0) -> Tuple[int, int]:
        """Feed mesh topology into every subsequent policy decision.

        Pass a ``torch.distributed.device_mesh.DeviceMesh`` (facts
        derived via :func:`repro_torch.launch.mesh.mesh_topology`) or
        explicit counts.  The pair lands in the ``n_nodes`` /
        ``ranks_per_node`` ctx fields, so topology-aware policies
        (``policies.mesh.topo_tuner``) can pick ring vs tree vs
        hierarchical schedules; it also joins the decision-cache key —
        changing topology can never serve a stale cached decision.
        Returns the stored pair."""
        if mesh is not None:
            from ..launch.mesh import mesh_topology
            topo = mesh_topology(mesh)
            n_nodes = topo["n_nodes"]
            ranks_per_node = topo["ranks_per_node"]
        self._n_nodes = max(0, int(n_nodes))
        self._ranks_per_node = max(0, int(ranks_per_node))
        return self._n_nodes, self._ranks_per_node

    @property
    def topology(self) -> Tuple[int, int]:
        """Current ``(n_nodes, ranks_per_node)`` fed to policies."""
        return self._n_nodes, self._ranks_per_node

    def register_mesh_sync(self, fn: Callable[[], object]) -> None:
        """Register a callback :meth:`sync_telemetry` runs to pull
        per-device telemetry shards home — typically a multi-shard
        ``DeviceBridge.flush`` or an in-graph state merge closure."""
        self._mesh_syncs.append(fn)

    def sync_telemetry(self) -> int:
        """The all-gather merge step: run every registered mesh-sync
        callback (each reconciles its per-device map shards into the
        pinned host maps via the deterministic shard merge), then flush
        the runtime's own bridges so single-shard in-graph state lands
        too.  Returns the number of registered callbacks run.
        Auto-triggered every ``config.telemetry_sync_every`` decisions
        when that knob is set; always safe to call manually."""
        synced = 0
        for fn in self._mesh_syncs:
            fn()
            synced += 1
        self.runtime.flush_bridges()
        self.telemetry_syncs += 1
        self._decisions_since_sync = 0
        return synced

    def _maybe_auto_sync(self) -> None:
        every = self.config.telemetry_sync_every
        if every <= 0:
            return
        self._decisions_since_sync += 1
        if self._decisions_since_sync >= every:
            self.sync_telemetry()

    def apply_env(self, *, n_devices: int = 0, tp: int = 0,
                  dp: int = 0, n_pods: int = 1) -> bool:
        """Run the attached env chain (NCCL env plugin analogue) against a
        real deployment topology; verified env programs may override the
        framework's default knobs.  The dispatcher calls this once at
        construction with zeroed topology; callers should re-invoke it
        after attaching an env program or when the topology is known.
        Returns True iff an env chain ran (knob changes participate in the
        decision-cache key, so no manual invalidation is needed)."""
        if not self.runtime.is_attached("env"):
            return False
        ctx = make_ctx("env", n_devices=n_devices, tp=tp, dp=dp,
                       n_pods=n_pods, topo_links=self.config.hw.n_links)
        self.runtime.invoke("env", ctx)
        cfg = self.config
        if ctx["default_algorithm"]:
            cfg.default_algo = int(ctx["default_algorithm"])
        if ctx["default_protocol"]:
            cfg.default_proto = int(ctx["default_protocol"])
        if ctx["default_channels"]:
            cfg.default_channels = min(int(ctx["default_channels"]),
                                       MAX_CHANNELS)
        if ctx["max_channels"]:
            cfg.max_channels = min(int(ctx["max_channels"]), MAX_CHANNELS)
        return True

    # historical name, kept for existing call sites
    def _apply_env_plugin(self, *, n_devices: int = 0, tp: int = 0,
                          dp: int = 0, n_pods: int = 1) -> None:
        self.apply_env(n_devices=n_devices, tp=tp, dp=dp, n_pods=n_pods)

    # ------------------------------------------------------------------
    def _policy_cacheable(self, links=None) -> bool:
        """A tuner decision can be memoized iff it is a pure function of
        the ctx inputs: no policy attached (framework default), or a chain
        in which every program calls no helpers (no map reads/writes, no
        clock, no randomness) — statically decidable from the bytecode.
        One stateful program anywhere in the chain disables memoization:
        first-non-deferring-wins means any link may end up deciding."""
        if links is None:
            links = self.runtime.chain("tuner")
        return all(
            not any(i.op == "call" for i in link.program.insns)
            for link in links)

    def _resync_cache(self) -> Tuple[int, int, bool, Dict[Tuple, Decision]]:
        """Rebuild the cache generation after a hot-reload epoch bump.

        The purity probe and the fingerprint must describe the SAME
        published chain (re-read the links tuple — identity changes on
        every publish — and retry on movement), and the epoch is read
        *before* the probe and re-checked *after* it: a swap landing
        mid-probe restarts the pairing, so the generation can never
        attach a new epoch to an older chain's fingerprint (which would
        leave the cache silently disabled — every insert rejected by
        the fingerprint guard — until some later unrelated bump)."""
        with self._cache_lock:
            gen = self._cache_gen
            if self.runtime.epoch == gen[0]:
                return gen                  # another thread already did it
            while True:
                ep = self.runtime.epoch
                links = self.runtime.chain("tuner")
                fp = self.runtime.chain_fingerprint("tuner")
                if self.runtime.chain("tuner") is not links:
                    continue                # republished mid-probe: re-pair
                cacheable = self.config.enable_decision_cache \
                    and self._policy_cacheable(links)
                if self.runtime.epoch != ep:
                    continue                # epoch moved mid-probe: re-pair
                gen = (ep, fp, cacheable, {})
                self._cache_gen = gen
                return gen

    def _san(self, v, lo: int) -> int:
        """Sanitize one dispatcher input.  Non-finite (NaN/inf),
        unconvertible, or below-range values are counted and clamped to
        ``lo`` — garbage telemetry must never reach a policy (it would
        poison map state and cost-model rows).  Plain in-range ints (the
        universal case) take the two-comparison fast path."""
        if type(v) is int:
            if v >= lo:
                return v
            self.fault_stats.invalid_inputs += 1
            return lo
        try:
            f = float(v)
        except (TypeError, ValueError):
            self.fault_stats.invalid_inputs += 1
            return lo
        if math.isnan(f) or math.isinf(f):
            self.fault_stats.invalid_inputs += 1
            return lo
        i = int(f)
        if i < lo:
            self.fault_stats.invalid_inputs += 1
            return lo
        return i

    def decide(self, coll: int, size_bytes: int, n: int, *,
               axis_kind: int = AxisKind.DATA, dtype_bytes: int = 4,
               axis_name: str = "?") -> Decision:
        self._decision_seq = seq = self._decision_seq + 1
        # spans only while a torch.profiler session runs (obs/trace.py):
        # one flag read a decision; the spans' boundaries stay in locals
        # and are stored once, as the call returns
        traced = _prof._is_profiler_enabled
        if traced:
            t0 = _spans.start()
        else:
            _spans.off = True
        cfg = self.config
        guards = cfg.enable_runtime_guards
        if guards:
            coll = self._san(coll, 0)
            size_bytes = self._san(size_bytes, 0)
            n = self._san(n, 1)
            axis_kind = self._san(axis_kind, 0)
            dtype_bytes = self._san(dtype_bytes, 1)
            if self._safe_mode and seq >= self._safe_until:
                # cooldown elapsed: half-open re-probe — resume invoking
                # policies; renewed faults refill the window and re-enter
                self._safe_mode = False
        safe = guards and self._safe_mode
        gen = self._cache_gen               # one atomic snapshot read
        if self.runtime.epoch != gen[0]:
            # hot-reload/attach/detach happened: flush and re-probe purity
            gen = self._resync_cache()
        gen_epoch, gen_fp, cacheable, cache = gen
        cid = _comm_id(axis_name, n)
        key = None
        if cacheable and not safe:
            # the chain fingerprint joins the epoch in every cache key:
            # epoch says "something changed", the fingerprint pins *which*
            # chain composition produced the cached decision
            key = (gen_epoch, gen_fp,
                   coll, size_bytes, n, axis_kind, dtype_bytes, cid,
                   cfg.default_algo, cfg.default_proto,
                   cfg.default_channels, cfg.max_channels,
                   cfg.hw.n_links,  # topo_links is a policy ctx input
                   self._n_nodes, self._ranks_per_node)
            d = cache.get(key)
            if d is not None:
                # memoization elides policy + cost-table work only; the
                # log and data-plane hooks still observe every dispatch
                self.cache_hits += 1
                if traced:
                    t1 = _ns()
                self.decisions.append(d)
                if traced:
                    t3 = _ns()
                self._net_hook(d)
                self._maybe_auto_sync()
                if traced:
                    _spans.decision(seq, t0, t1, t1, t3)
                return d
            self.cache_misses += 1
        if traced:
            t1 = _ns()
        faulted = False
        if safe:
            # safe mode: tuner policies are detached from the decision
            # path entirely — pure cost-model default, no policy code runs
            self.fault_stats.safe_mode_decisions += 1
            from_policy = False
            algo = proto = channels = 0
        else:
            ctx = make_ctx(
                "tuner",
                coll_type=coll, msg_size=size_bytes, n_ranks=n, comm_id=cid,
                axis_kind=axis_kind, dtype_bytes=dtype_bytes,
                max_channels=cfg.max_channels, topo_links=cfg.hw.n_links,
                algorithm=0, protocol=0, n_channels=0,
                n_nodes=self._n_nodes, ranks_per_node=self._ranks_per_node,
            )
            lf_before = self.runtime.stats.link_faults if guards else 0
            try:
                _faults.fire("decide")
                ret = self.runtime.invoke("tuner", ctx)
            except Exception as exc:
                if not guards:
                    raise
                # the guard contract: no policy exception escapes decide()
                faulted = True
                ret = None
                self._record_policy_fault(exc)
            from_policy = ret is not None
            if faulted:
                # discard any partial ctx writes the failing chain made
                algo = proto = channels = 0
                from_policy = False
            else:
                algo = ctx["algorithm"]
                proto = ctx["protocol"]
                channels = ctx["n_channels"]
                if guards and self.runtime.stats.link_faults > lf_before:
                    # a multi-link chain contained a per-link fault and
                    # produced a healthy decision from the surviving
                    # links; it still feeds the safe-mode window
                    self._note_fault()

        if not from_policy or (algo == 0 and proto == 0 and channels == 0):
            # no policy attached, or policy deferred: framework default
            algo, proto = cfg.default_algo, cfg.default_proto
            channels = cfg.default_channels
            from_policy = False

        # --- tuner-v5 cost-table translation + graceful fallback ----------
        table = self.cost_model.cost_table_cached(coll, size_bytes, n,
                                                  channels=max(channels, 1))
        if algo >= Algo.COUNT or proto >= Proto.COUNT \
                or channels > 0xFFFFFFFF:
            # out-of-domain decision: sentinel cost -> framework default.
            # Under guards this is a policy fault — charged to the
            # deciding link's breaker and to the safe-mode window.
            if guards and from_policy:
                self.fault_stats.invalid_decisions += 1
                self.runtime.record_fault(
                    self.runtime.last_decider("tuner"), None,
                    section="tuner")
                self._note_fault()
            algo, proto = cfg.default_algo, cfg.default_proto
            channels = cfg.default_channels
            from_policy = False
        # argmin with the policy's (algo, proto) cost zeroed — equivalent
        # to mutating a fresh table, but against the memoized rows; strict
        # `<` preserves the original first-minimum tie-break order
        best_a = best_p = 0
        best_c = float("inf")
        for a in range(Algo.COUNT):
            row = table[a]
            for p in range(Proto.COUNT):
                c = 0.0 if (a == algo and p == proto) else row[p]
                if c < best_c:
                    best_a, best_p, best_c = a, p, c
        algo, proto = best_a, best_p

        # --- clamp channels (NCCL maxChannels contract) --------------------
        channels = max(1, min(int(channels) or cfg.default_channels,
                              cfg.max_channels))

        d = Decision(coll=coll, algo=algo, proto=proto, channels=channels,
                     size_bytes=size_bytes, n_ranks=n, axis_kind=axis_kind,
                     comm_id=cid, from_policy=from_policy)
        if key is not None and not faulted:
            # a faulted decision is a degraded default, not the chain's
            # answer — caching it would keep serving the fallback after
            # the fault clears
            if len(cache) >= cfg.decision_cache_max:
                self._evict_oldest_half(cache)
            # insert guard: publish into the generation only while its
            # (epoch, fingerprint) pairing still holds.  A swap that
            # landed between our invoke and this insert must not plant
            # the NEW chain's decision where stale in-flight readers of
            # this generation would mistake it for a cacheable one (the
            # new chain may be stateful: its decisions must never be
            # served from the cache).
            if self.runtime.epoch == gen_epoch \
                    and self.runtime.chain_fingerprint("tuner") == gen_fp:
                cache[key] = d
        if traced:
            t2 = _ns()
        self.decisions.append(d)
        if traced:
            t3 = _ns()
        self._net_hook(d)
        self._maybe_auto_sync()
        if traced:
            _spans.decision(seq, t0, t1, t2, t3)
        return d

    def _evict_oldest_half(self, cache: Dict[Tuple, Decision]) -> None:
        """Within-epoch overflow: drop the oldest half by insertion order
        (dicts preserve it).  Clearing everything instead would wipe the
        hot entries too and cause a periodic full-recompute storm under
        bursts of distinct keys."""
        with self._cache_lock:
            n = len(cache)
            if n < self.config.decision_cache_max:
                return                      # another thread already evicted
            # list(dict) is a single C-level op, safe against concurrent
            # lock-free inserts from the hit path
            for k in list(cache)[:max(n // 2, 1)]:
                cache.pop(k, None)

    # ------------------------------------------------------------------
    # fault containment
    # ------------------------------------------------------------------
    def _record_policy_fault(self, exc: BaseException, *,
                             section: str = "tuner") -> None:
        """An exception escaped a policy chain: count it, charge the
        section's highest-precedence active link (depth-1 chains raise
        straight through; multi-link chains contain per-link), and feed
        the safe-mode window."""
        self.fault_stats.policy_exceptions += 1
        self.runtime.record_fault(None, exc, section=section)
        self._note_fault()

    def _note_fault(self) -> None:
        """Slide one fault mark into the dispatcher window; trip safe
        mode when `safe_mode_threshold` marks land within the last
        `safe_mode_window` decisions."""
        if self._safe_mode:
            return
        cfg = self.config
        now = self._decision_seq
        marks = self._fault_marks
        marks.append(now)
        while marks and now - marks[0] > cfg.safe_mode_window:
            marks.popleft()
        if len(marks) >= cfg.safe_mode_threshold:
            marks.clear()
            self._safe_mode = True
            self._safe_until = now + cfg.safe_mode_cooldown
            self.fault_stats.safe_mode_entries += 1

    @property
    def safe_mode(self) -> bool:
        """True while tuner policies are detached from the decision path
        (entered automatically when the fault window fills)."""
        return self._safe_mode

    def clear_safe_mode(self) -> None:
        """Operator override: exit safe mode and forget the window."""
        self._safe_mode = False
        self._fault_marks.clear()

    def health(self) -> Dict[str, object]:
        """One structured health dict for the whole decision plane: the
        runtime view (per-link breaker state, aggregated device-bridge
        counters, observability-plane loss accounting — see
        :meth:`PolicyRuntime.health`) merged with the dispatcher-level
        view: safe-mode latch, fault accounting, and the decision log's
        ring counters."""
        h = self.runtime.health()
        h["dispatcher"] = {
            "safe_mode": self._safe_mode,
            "fault_stats": dataclasses.asdict(self.fault_stats),
            "fault_total": self.fault_stats.total,
            "decision_log": {"stored": len(self.decisions),
                             "capacity": self.decisions.maxlen,
                             "drops": self.decisions.drops},
            "cache": {"hits": self.cache_hits,
                      "misses": self.cache_misses,
                      "entries": self.decision_cache_len},
        }
        return h

    # ------------------------------------------------------------------
    def make_ingraph(self, *, tier: str = "cuda"):
        """Route the attached tuner policy through an in-graph tier.

        Returns ``(selector, state)``: an
        :class:`~repro_torch.collectives.ingraph.InGraphSelector` built
        from the highest-precedence attached tuner program (``tier=
        "cuda"`` for the CUDA policy kernel over u64 words, ``"cuda32"``
        for the pair-form kernel, ``"torchc"`` for ``torchc``'s
        predicated lowering as tensor ops on the card, ``"torch"`` for
        the plain version on the CPU) plus device-resident map state
        seeded from THIS
        runtime's live maps — host-accumulated telemetry moves to the
        device, and from then on decisions run there.  Thread ``state``
        through the steps; ``merge_shard_states`` (or
        :func:`repro_torch.core.torchc.array_to_map` /
        :func:`repro_torch.core.pair.array32_to_map`) writes it back to
        the host maps."""
        from .ingraph import InGraphSelector
        lp = self.runtime.attached("tuner")
        if lp is None:
            raise RuntimeError(
                "no tuner policy attached; attach one before routing "
                "decisions in-graph")
        sel = InGraphSelector(lp.program, tier=tier)
        return sel, sel.init_state(self.runtime.maps)

    def _net_hook(self, d: Decision) -> None:
        if not self.config.enable_net_hook:
            return
        if not self.runtime.is_attached("net"):
            return
        nctx = make_ctx("net", op=0, bytes=d.size_bytes,
                        peer=(d.comm_id + 1) % max(d.n_ranks, 1),
                        comm_id=d.comm_id, conn_id=d.coll)
        try:
            self.runtime.invoke("net", nctx)
        except Exception as exc:
            if not self.config.enable_runtime_guards:
                raise
            # accounting path fault: charged to the net link's breaker;
            # never disturbs the dispatch (and the event is not counted —
            # the accounting program did not process it)
            self.fault_stats.policy_exceptions += 1
            self.runtime.record_fault(None, exc, section="net")
            return
        self.net_calls += 1
        self.net_bytes += d.size_bytes

    # ------------------------------------------------------------------
    # collective entry points: ``x`` is this rank's tensor, ``group`` the
    # process group the axis runs over (None: the default group)
    # ------------------------------------------------------------------
    def _dispatch(self, coll: int, x, axis_name: str, axis_kind: int,
                  group=None, **kw):
        n = dist.get_world_size(group)
        if n == 1 and coll in (CollType.ALL_REDUCE,):
            return x
        size_bytes = x.numel() * x.element_size()
        d = self.decide(coll, size_bytes, n, axis_kind=axis_kind,
                        dtype_bytes=x.element_size(), axis_name=axis_name)
        fn = _algo_fn(coll, d.algo)
        return fn(x, group, n_channels=d.channels, protocol=d.proto, **kw)

    def all_reduce(self, x, axis_name: str, *, group=None,
                   axis_kind: int = AxisKind.DATA):
        return self._dispatch(CollType.ALL_REDUCE, x, axis_name, axis_kind,
                              group)

    # psum-compatible alias, as in the reference
    def psum(self, x, axis_name: str, *, group=None,
             axis_kind: int = AxisKind.DATA):
        return self.all_reduce(x, axis_name, group=group,
                               axis_kind=axis_kind)

    def reduce_scatter(self, x, axis_name: str, *, group=None,
                       axis_kind: int = AxisKind.DATA):
        return self._dispatch(CollType.REDUCE_SCATTER, x, axis_name,
                              axis_kind, group)

    def all_gather(self, x, axis_name: str, *, group=None,
                   axis_kind: int = AxisKind.MODEL):
        return self._dispatch(CollType.ALL_GATHER, x, axis_name, axis_kind,
                              group)

    def all_to_all(self, x, axis_name: str, *, group=None,
                   axis_kind: int = AxisKind.EXPERT, **kw):
        return self._dispatch(CollType.ALL_TO_ALL, x, axis_name, axis_kind,
                              group, **kw)

    # ------------------------------------------------------------------
    # profiler ctx fast path: every profiler field is a read-only u64 in
    # declaration order, so the always-on feed packs them straight into
    # a fresh buffer — no PolicyContextValues construction per event
    # (that wrapper costs more than running both profiler policies)
    _PROF_PACK = struct.Struct("<8Q")
    _M64 = 0xFFFFFFFFFFFFFFFF

    def profiler_feed(self, comm_id: int, latency_ns: int, *, coll: int = 0,
                      msg_size: int = 0, channels: int = 0, algo: int = 0,
                      ts_ns: int = 0) -> None:
        """Deliver a latency observation to the attached profiler chain."""
        fn = self.runtime.invoke_fn("profiler")
        if fn is None:
            return
        M = self._M64
        buf = bytearray(PROFILER_CONTEXT.size)
        self._PROF_PACK.pack_into(
            buf, 0, 1, coll & M, msg_size & M, comm_id & M,
            latency_ns & M, channels & M, algo & M, ts_ns & M)
        try:
            fn(buf)
        except Exception as exc:
            if not self.config.enable_runtime_guards:
                raise
            self.fault_stats.policy_exceptions += 1
            self.runtime.record_fault(None, exc, section="profiler")

    @property
    def epoch(self) -> int:
        """Policy epoch — include in step cache keys; bumps on hot-reload."""
        return self.runtime.epoch

    def clear_log(self) -> None:
        self.decisions.clear()

    def clear_decision_cache(self) -> None:
        """Manual invalidation hook (e.g. after mutating ``config``
        mid-run outside the epoch mechanism)."""
        with self._cache_lock:
            self._cache_gen = (-1, 0, False, {})

    @property
    def decision_cache_len(self) -> int:
        """Entries in the current cache generation (introspection)."""
        return len(self._cache_gen[3])


_DISPATCHER: Optional[CollectiveDispatcher] = None
_DISPATCHER_LOCK = threading.Lock()


def dispatcher() -> CollectiveDispatcher:
    global _DISPATCHER
    with _DISPATCHER_LOCK:
        if _DISPATCHER is None:
            _DISPATCHER = CollectiveDispatcher()
        return _DISPATCHER


def reset_dispatcher(config: Optional[DispatchConfig] = None,
                     runtime: Optional[PolicyRuntime] = None,
                     tier: Optional[str] = None
                     ) -> CollectiveDispatcher:
    global _DISPATCHER
    with _DISPATCHER_LOCK:
        _DISPATCHER = CollectiveDispatcher(runtime=runtime, config=config,
                                           tier=tier)
        return _DISPATCHER
