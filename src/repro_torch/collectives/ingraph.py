"""In-graph adaptive dispatch: a verified policy selects the collective
algorithm per STEP, with its map state resident on the device.

The port of ``repro/collectives/ingraph.py``.  The policy kernel reads
live telemetry from a map state the caller threads through its steps
(a dict of device tensors), and its decision picks one of the
pre-built algorithm branches.  Four tiers share the entry point:

  * ``tier="cuda"`` (the default) — the hand-written CUDA policy kernel
    (:mod:`repro_torch.core.cudac`, B1) over u64 words;
  * ``tier="cuda32"`` — the same decision as the pair-form kernel (B2)
    over ``[lo, hi]`` pairs (:mod:`repro_torch.core.pair`);
  * ``tier="torchc"`` — ``torchc``'s predicated lowering
    (:func:`repro_torch.core.torchc.compile_predicated`, the port of the
    reference's ``jaxc`` tier) as tensor ops, on the card unless
    ``device="cpu"`` is asked for;
  * ``tier="torch"`` — the kernel's plain PyTorch version on the CPU.

``cuda``, ``cuda32`` and ``torchc`` raise
:class:`~repro_torch.device.DeviceError` without a CUDA device (``torchc``
unless given ``device="cpu"``).

:meth:`InGraphSelector.decide` never synchronises: the ctx goes up from
pinned memory without blocking (inside a capture it is built on the card
by fills), the kernel launches on the current stream, and the domain
clamp and the counter updates are device ops.  Eagerly,
:meth:`InGraphSelector.all_reduce` picks the branch on the host — one
``int(algo)`` per step, counted in :attr:`InGraphSelector.host_syncs`,
since a ``torch.distributed`` call is issued by the host.  Called inside
a ``torch.cuda.graph`` capture, it is the reference's ``lax.switch``:
the decision and every branch are captured, and a switch node
(:mod:`repro_torch.core.graphs`) picks the branch on the card at each
replay, with no host read.  A captured step needs a group whose backend
a graph can capture (NCCL), one eager step on the same shapes before the
capture (NCCL's communicator, the kernels' builds, the allocator), and
static state: the step copies the state ``all_reduce`` returns into the
tensors it was given, as any static-buffer CUDA-graph code does.

The CUDA kernel updates its maps in place, while the reference's
``decide`` returns a new state and leaves the caller's untouched (the
shard merge relies on it: ``base_state`` is the state every shard
started from).  So ``decide`` copies the leaves the program can write
(:attr:`InGraphSelector.written_names`) before the launch and shares
the lookup-only leaves with the old state.

Usage::

    sel = InGraphSelector(policy_program, tier="cuda32")
    state = sel.init_state()
    ...each step:
    y, algo, state = sel.all_reduce(x, "data", state, group=pg,
                                    latency_ns=obs)

    ...or captured once (``pg`` an NCCL group, ``obs`` a tensor on the
    card written before each replay):
    sel.all_reduce(x, "data", state, group=pg, latency_ns=obs)  # warm-up
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        y, algo, new = sel.all_reduce(x, "data", state, group=pg,
                                      latency_ns=obs)
        for k in state:
            state[k].copy_(new[k])
    ...each step: obs.fill_(latency); g.replay()
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core import graphs
from ..core import shardmerge as _sm
from ..core.context import CollType, POLICY_CONTEXT
from ..core.cudac import PolicyKernel, check_supported32
from ..core.maps import MapRegistry
from ..core.pair import map_to_array32, words_to_pairs
from ..core.program import Program
from ..core.torchc import (check_supported, compile_predicated,
                           map_to_array, written_map_names)
from ..core.verifier import verify_with_info
from ..device import require_cuda, resolve_device
from . import algorithms as alg

_FIELDS = list(POLICY_CONTEXT.fields)
_IDX = {name: i for i, name in enumerate(_FIELDS)}

# branch table: algorithm id -> implementation (uniform signature)
_BRANCHES = [
    ("default", lambda x, g: alg.allreduce_native(x, g)),
    ("ring", lambda x, g: alg.allreduce_ring(x, g, n_channels=4)),
    ("tree", lambda x, g: alg.allreduce_tree(x, g)),
    ("bidir_ring", lambda x, g: alg.allreduce_bidir_ring(x, g,
                                                         n_channels=2)),
]

TIERS = ("torch", "cuda", "cuda32", "torchc")

# extra state leaf carrying the in-graph fault flag: the kernel cannot
# throw, so out-of-domain decisions are clamped on the device and counted
# here (a [1] counter that wraps at 2**32, threaded with the map state);
# hosts drain it at flush boundaries via InGraphSelector.drain_faults
FAULT_KEY = "__fault_flags__"

# per-shard write cursor: how many decide() calls have run against this
# state copy (a [1] counter bumped on the device, wrapping at 2**32).
# Every rank threads its OWN state, so the copies diverge; the cursor is
# the version the deterministic shard merge (merge_shard_states) uses
# for its max-version-wins cells
CURSOR_KEY = "__write_cursor__"

# the two counters hold the reference's uint32 bits in int32 (torch's
# uint32 has no add), like the pair lanes
_COUNTER_DTYPE = torch.int32
_MAX_CHANNELS = 32


class InGraphSelector:
    TIERS = TIERS

    def __init__(self, program: Program, *, tier: str = "cuda",
                 device=None):
        """``device`` is where ``tier="torchc"`` runs: the card when
        None, ``"cuda"`` or ``"cuda:N"``, the CPU with ``"cpu"``, held in
        the form its tensors report (:func:`resolve_device`); the other
        tiers take none."""
        if tier not in TIERS:
            raise ValueError(f"unknown in-graph tier {tier!r}; "
                             f"use one of {', '.join(TIERS)}")
        what = f"InGraphSelector(tier={tier!r})"
        if tier == "torchc":
            check_supported(program)        # the reference jaxc's messages
            self.device = resolve_device(device, what)
        elif device is not None:
            raise ValueError(f"{what} takes no device (its device is the "
                             "tier's); device= is for tier='torchc'")
        elif tier == "torch":
            self.device = torch.device("cpu")
        else:
            if tier == "cuda32":
                check_supported32(program)
            self.device = require_cuda(what)
        vinfo = verify_with_info(program)
        self.program = program
        self.tier = tier
        self.word_width = 32 if tier == "cuda32" else 64
        # the program's CUDA kernel (B1 / B2); tier "torchc" never
        # launches it, its launches stay 0
        self.kernel = PolicyKernel(program, vinfo)
        self._predicated = compile_predicated(program, vinfo)[0] \
            if tier == "torchc" else None
        if self.device.type == "cuda":
            if tier != "torchc":
                self.kernel.build()
            graphs.build()
        self.map_names = list(self.kernel.names)
        # maps the verified program can write — the only leaves decide()
        # copies and the shard merge reconciles (lookup-only state can't
        # diverge)
        self.written_names = written_map_names(program, vinfo) \
            & set(self.map_names)
        # host reads of the chosen algorithm (one per eager all_reduce
        # step; a captured step reads nothing)
        self.host_syncs = 0
        # memory pools of captured switch nodes' bodies: a graph replays
        # into them for as long as it lives
        self._body_pools: List[object] = []

    def init_state(self, registry: Optional[MapRegistry] = None
                   ) -> Dict[str, torch.Tensor]:
        """Device-resident map state (thread it through your steps).

        With ``registry`` (e.g. a live runtime's ``maps``), the state is
        seeded from the existing host maps — telemetry a profiler already
        accumulated moves to the device instead of starting cold.  The
        layout follows the tier's word width: ``int64`` u64 words for
        ``cuda`` and ``torch``, ``int32[..., 2]`` ``[lo, hi]`` pairs for
        ``cuda32``."""
        reg = registry or MapRegistry()
        to_array = map_to_array32 if self.word_width == 32 else map_to_array
        out = {}
        for d in self.program.maps:
            m = reg.create(d.name, d.kind, key_size=d.key_size,
                           value_size=d.value_size,
                           max_entries=d.max_entries)
            with m.lock:
                out[d.name] = to_array(m, self.device)
        out[FAULT_KEY] = torch.zeros(1, dtype=_COUNTER_DTYPE,
                                     device=self.device)
        out[CURSOR_KEY] = torch.zeros(1, dtype=_COUNTER_DTYPE,
                                      device=self.device)
        return out

    def _ctx_vec(self, fields: Dict[str, object]) -> torch.Tensor:
        """The ctx as ``int64[n_fields]`` u64 words on the device (the
        pair form views the same bytes).

        Python and numpy integers go up exactly.  On the 32-bit path a
        float (e.g. a float32 latency that can exceed 2**32 ns) is split as
        the reference splits it, ``hi = floor(v / 2**32)``, ``lo = v - hi
        * 2**32`` in the input's float dtype (a Python float is float32
        there, as in JAX without x64), so the policy sees the same bits; a
        tensor integer rides the lo lane (``v mod 2**32``).  On the 64-bit
        path a value converts to u64 (floats truncate).

        Inside a CUDA-graph capture a copy from host memory would read
        its buffer at every replay, so the words are fills on the device
        and a tensor value must already lie there (a host tensor would
        be read once, at capture); a Python or numpy value is a constant
        of the graph, like the message size."""
        capturing = graphs.capturing()
        words = [0] * len(_FIELDS)
        traced = []
        for name, v in fields.items():
            if isinstance(v, (int, np.integer)):
                v = int(v) & ((1 << 64) - 1)
                words[_IDX[name]] = v - (1 << 64) if v >> 63 else v
                continue
            if not isinstance(v, torch.Tensor):
                v = torch.as_tensor(np.asarray(v))
                if self.word_width == 32 and v.dtype == torch.float64:
                    v = v.to(torch.float32)
                if capturing:
                    v = torch.full((), v.item(), dtype=v.dtype,
                                   device=self.device)
            elif capturing and v.device != self.device:
                raise ValueError(
                    f"ctx field {name!r}: a captured step reads a tensor "
                    f"on {self.device}, got one on {v.device} (its value "
                    "would be read once, at capture)")
            traced.append((_IDX[name], v))
        if capturing:
            vec = torch.zeros(len(_FIELDS), dtype=torch.int64,
                              device=self.device)
            for i, w in enumerate(words):
                if w:
                    vec[i].fill_(w)     # a fill: no host tensor to copy
        elif self.device.type == "cuda":
            # pinned and non-blocking: the copy never waits for the
            # stream's earlier work
            vec = torch.tensor(words, dtype=torch.int64).pin_memory().to(
                self.device, non_blocking=True)
        else:
            vec = torch.tensor(words, dtype=torch.int64)
        for i, v in traced:
            v = v.to(self.device).reshape(())
            if v.is_floating_point() and self.word_width == 32:
                hi = torch.floor(v / (2.0 ** 32))
                lo = v - hi * (2.0 ** 32)
                w = (lo.to(torch.int64) & 0xFFFFFFFF) \
                    | ((hi.to(torch.int64) & 0xFFFFFFFF) << 32)
            elif self.word_width == 32:
                w = v.to(torch.int64) & 0xFFFFFFFF
            else:
                w = v.to(torch.int64)
            vec[i] = w
        return vec

    def decide(self, state: Dict, *, coll: int, msg_bytes: int, n: int,
               comm_id: int = 0, latency_ns=None
               ) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
        """Run the verified policy on the device.

        Returns ``(algo, channels, new_state)``: two int32 scalars on the
        state's device and a new state; ``state`` itself is unchanged (a
        captured step copies ``new_state`` into the tensors of its static
        ``state``)."""
        fields: Dict[str, object] = {
            "coll_type": int(coll), "msg_size": int(msg_bytes),
            "n_ranks": int(n), "comm_id": int(comm_id),
            "max_channels": _MAX_CHANNELS,
        }
        if latency_ns is not None:
            # live telemetry rides the ctx's dtype_bytes field
            fields["dtype_bytes"] = latency_ns
        vec = self._ctx_vec(fields)
        flags = state.get(FAULT_KEY)
        cursor = state.get(CURSOR_KEY)
        prog_state = {k: v for k, v in state.items()
                      if k not in (FAULT_KEY, CURSOR_KEY)}
        if self.tier == "torchc":
            # functional: written maps come back as new tensors
            _, vec, prog_state = self._predicated(vec, prog_state)
            raw_algo = vec[_IDX["algorithm"]].to(torch.int32)
            raw_ch = vec[_IDX["n_channels"]].to(torch.int32)
        else:
            # the kernel writes in place: copy the leaves it can write
            prog_state = {k: (v.clone() if k in self.written_names else v)
                          for k, v in prog_state.items()}
            if self.word_width == 32:
                vec2 = words_to_pairs(vec)
                ret = torch.zeros(2, dtype=torch.int32, device=self.device)
                self.kernel.launch32(vec2, ret, prog_state)
                raw_algo = vec2[_IDX["algorithm"], 0]
                raw_ch = vec2[_IDX["n_channels"], 0]
            else:
                ret = torch.zeros(1, dtype=torch.int64, device=self.device)
                self.kernel.launch(vec, ret, prog_state)
                raw_algo = vec[_IDX["algorithm"]].to(torch.int32)
                raw_ch = vec[_IDX["n_channels"]].to(torch.int32)
        # the kernel cannot throw, so the domain guard is a clamp on the
        # device; any clamp that changed the value bumps the fault flag
        algo = raw_algo.clamp(0, len(_BRANCHES) - 1)
        ch = raw_ch.clamp(0, _MAX_CHANNELS)
        state = dict(prog_state)
        if flags is not None:
            bad = ((raw_algo != algo) | (raw_ch != ch)).to(_COUNTER_DTYPE)
            state[FAULT_KEY] = flags + bad
        if cursor is not None:
            state[CURSOR_KEY] = cursor + 1
        return algo, ch, state

    def drain_faults(self, state: Dict) -> Tuple[int, Dict]:
        """Read-and-zero the in-graph fault counter (a host sync point —
        call it at the cadence of ``DeviceBridge.flush``).  Returns
        ``(n_faults, state_with_cleared_flag)``; states without the flag
        leaf drain as 0."""
        flags = state.get(FAULT_KEY)
        if flags is None:
            return 0, state
        n = int(flags.cpu().numpy().view("<u4")[0])
        state = dict(state)
        state[FAULT_KEY] = torch.zeros_like(flags)
        return n, state

    # ------------------------------------------------------------------
    # mesh-scale state: per-rank shards -> one merged host view
    # ------------------------------------------------------------------
    @staticmethod
    def unstack_sharded(state: Dict) -> List[Dict]:
        """Split a state whose leaves carry a leading SHARD axis (e.g.
        ``torch.stack`` of each rank's leaves, or states gathered with
        ``dist.gather_object`` and stacked) into one per-shard state list
        for :meth:`merge_shard_states`."""
        leaves = {k: (v.detach().cpu() if isinstance(v, torch.Tensor)
                      else torch.as_tensor(np.asarray(v)))
                  for k, v in state.items()}
        counts = {v.shape[0] for v in leaves.values()}
        if len(counts) != 1:
            raise ValueError(
                f"inconsistent leading device axis across state leaves: "
                f"{sorted(counts)}")
        n = counts.pop()
        return [{k: v[i] for k, v in leaves.items()} for i in range(n)]

    def _host_u64(self, arr) -> np.ndarray:
        a = np.asarray(arr.detach().cpu() if isinstance(arr, torch.Tensor)
                       else arr)
        if self.word_width == 32:
            return _sm.pairs_to_u64(a)
        return a.astype("<i8", copy=False).view("<u8")

    def merge_shard_states(self, registry: MapRegistry,
                           shard_states, base_state: Dict,
                           stats: Optional[dict] = None) -> int:
        """Publish per-rank state shards back into the host maps.

        ``shard_states`` is one state dict per rank (a list, e.g. from
        ``dist.gather_object``, or :meth:`unstack_sharded` of a stacked
        state), each carrying the diverged map leaves plus its
        ``CURSOR_KEY`` write count; ``base_state`` is the state they were
        ALL seeded from (what :meth:`init_state` returned).  Each written
        map reconciles via the deterministic shard merge
        (:mod:`repro_torch.core.shardmerge`): counter slots sum per-shard
        deltas, ``merge="max"`` cells go to the shard with the highest
        cursor, hash maps merge per key — bit-identical for any shard
        count and order.  Returns the number of maps merged."""
        merged_maps = 0
        for d in self.program.maps:
            if d.name not in self.written_names:
                continue
            base64 = self._host_u64(base_state[d.name])
            shards = []
            for sid, st in enumerate(shard_states):
                cur = st.get(CURSOR_KEY)
                cur = int(np.asarray(cur.detach().cpu() if isinstance(
                    cur, torch.Tensor) else cur).reshape(-1).view("<u4")[0]) \
                    if cur is not None else 1
                if cur == 0:
                    continue
                shards.append(_sm.Shard(sid, self._host_u64(st[d.name]),
                                        cur, base64))
            if not shards:
                continue
            m = registry.create(d.name, d.kind, key_size=d.key_size,
                                value_size=d.value_size,
                                max_entries=d.max_entries)
            with m.lock:
                m.from_device(_sm.merge_map_shards(d, m.to_device(),
                                                   shards, stats))
            merged_maps += 1
        return merged_maps

    def all_reduce(self, x: torch.Tensor, axis_name: str, state: Dict, *,
                   group=None, comm_id: int = 0, latency_ns=None):
        """Policy-selected all-reduce over ``group`` (``axis_name`` names
        the axis, as in the reference).  The decision stays on the
        device.  Eagerly the branch is picked on the host with one
        ``int(algo)`` (counted in :attr:`host_syncs`); inside a CUDA-graph
        capture every branch is captured into a switch node and the card
        picks one at each replay (``y`` is then a tensor of the graph).
        Returns ``(y, algo, state)``."""
        capturing = graphs.capturing()
        if capturing:
            _check_capturable(group)
        n = dist.get_world_size(group)
        algo, _, state = self.decide(
            state, coll=CollType.ALL_REDUCE,
            msg_bytes=x.numel() * x.element_size(), n=n,
            comm_id=comm_id, latency_ns=latency_ns)
        if capturing:
            pool = torch.cuda.MemPool()
            self._body_pools.append(pool)
            y = graphs.captured_switch(
                algo, [lambda f=f: f(x, group) for _, f in _BRANCHES],
                torch.empty_like(x), pool)
            return y, algo, state
        pick = int(algo)
        self.host_syncs += 1
        y = _BRANCHES[pick][1](x, group)
        return y, algo, state


def _check_capturable(group) -> None:
    """A captured collective needs a backend whose work a CUDA graph can
    hold: NCCL's kernels run on the capturing stream, gloo's run on the
    host."""
    backend = str(dist.get_backend(group))
    if "nccl" not in backend:
        raise RuntimeError(
            f"InGraphSelector.all_reduce inside a CUDA-graph capture needs "
            f"an NCCL group; this group's backend is {backend!r}, whose "
            "collectives run on the host and cannot be captured")


__all__ = ["InGraphSelector", "FAULT_KEY", "CURSOR_KEY", "TIERS"]
