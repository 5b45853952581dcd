"""Roofline analysis from one meta-tensor run of the port's step (the port
of ``repro/launch/roofline.py``).

Three terms per (arch × shape × mesh), in seconds:

  compute    = trace_FLOPs / peak_FLOP/s        (per rank)
  memory     = trace_bytes / HBM_bw             (per rank)
  collective = collective_wire_bytes / (links × link_bw)

The reference parses the compiled HLO text; the port has no compiled
artifact, so :class:`TraceAnalyzer` (a ``TorchDispatchMode``) watches
every ATen op of one eager run of the step on meta tensors (one rank of
the mesh, its collectives over a fake process group) and accumulates:

  * FLOPs      — from the matmul-class ops (``mm``, ``bmm``, ``addmm``,
                 ``baddbmm``, convolutions, fused attention), counted by
                 ``torch.utils.flop_counter``'s formulas: the
                 counterpart of the reference's ``dot`` parsing.  Eager
                 mode runs a layer loop's body once per layer, so no
                 multiplicity pass is needed
  * HBM bytes  — inputs + outputs of every ATen op that is not a view
                 or an allocation (each eager op is one kernel: the
                 counterpart of "top-level instructions, fusion
                 internals excluded"); a tensor an op both reads and
                 writes in place counts once
  * wire bytes — per collective the process group emits (the ``c10d``
                 ops, with g = the group's size), by the reference's
                 formulas:
                   all-reduce          2·(g-1)/g · S
                   all-gather          (g-1)/g · S_result
                   reduce-scatter      (g-1) · S_result  (= (g-1)/g · S_in)
                   all-to-all          (g-1)/g · S
                   collective-permute  S     (one point-to-point send;
                                              receives are not counted)
                 A ring or tree algorithm the dispatcher picks shows as
                 its sends, as the reference's ``ppermute`` rings show as
                 collective-permutes
  * working set — the bytes of the live storages: the step's arguments,
                 plus every storage an op creates, freed when its last
                 reference dies (``weakref.finalize`` on the output's
                 ``untyped_storage()``), reported under the reference's
                 ``memory_analysis`` keys.  ``generated_code_size_in_bytes``
                 has no counterpart (eager mode generates no code) and is
                 left out.

Hardware constants: the NVIDIA H100 SXM datasheet — 989 TFLOP/s dense
bf16 (tensor cores), 3.35 TB/s HBM3, NVLink 4 with 18 links at 25 GB/s
per direction each.  A card set below its 700 W maximum runs slower
under load: the measured numbers these are held against carry the
card's name and power limit.

The AllReduce predictor below keeps the reference's formula and the
parameters ``topo_tuner``'s thresholds were fitted to
(``FITTED_LINK_BW``, ``LINK_LATENCY_S``): they describe the shipped
policy, not the card.
"""

from __future__ import annotations

import time
import weakref
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pytree_leaves
from torch.utils.flop_counter import flop_registry

PEAK_FLOPS = 989e12          # dense bf16 / card, tensor cores
HBM_BW = 3.35e12             # B/s / card, HBM3
LINK_BW = 25e9               # B/s / NVLink 4 link, per direction
N_LINKS = 18                 # NVLink 4 links per card

# ops that move no bytes: views alias their input, allocations write
# nothing, and ``set_`` swaps a tensor's storage
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "detach", "alias", "lift_fresh",
               "_unsafe_view", "set_"}

# c10d op -> the reference's HLO name for it
_COLL = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "_allgather_base_": "all-gather", "allgather_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
    "send": "collective-permute",
}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in _pytree_leaves(tree) if isinstance(t, torch.Tensor)]


def _group_size(args) -> int:
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return dist.ProcessGroup.unbox(a).size()
            except (RuntimeError, TypeError):
                continue
    return dist.get_world_size()


def wire_bytes(op: str, g: int, s: float) -> float:
    """The reference's wire bytes of one collective of ``g`` ranks;
    ``s`` is the result's bytes (the operand's for all-reduce, all-to-all
    and a permute's send)."""
    if op == "all-reduce":
        return 2.0 * (g - 1) / g * s
    if op == "all-gather":
        return (g - 1) / g * s
    if op == "reduce-scatter":
        return float(g - 1) * s
    if op == "all-to-all":
        return (g - 1) / g * s
    return float(s)                                  # collective-permute


class TraceAnalyzer(TorchDispatchMode):
    """Counts FLOPs, HBM bytes, wire bytes and live storage bytes of every
    ATen op run under it (see the module docstring).  Register the
    step's inputs with :meth:`arguments` before the run and its outputs
    with :meth:`outputs` after."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.wire_bytes = 0.0
        self.by_op: Dict[str, Dict[str, float]] = {}
        self.ops = 0
        self.arg_bytes = 0
        self.out_bytes = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._arg_storages: set = set()
        self._live: Dict[int, int] = {}

    # -- storages ---------------------------------------------------------
    def arguments(self, tree) -> None:
        """The step's inputs: counted once as arguments, never as temps."""
        for t in _tensors(tree):
            st = t.untyped_storage()
            if id(st) not in self._arg_storages:
                self._arg_storages.add(id(st))
                self.arg_bytes += st.nbytes()

    def outputs(self, tree) -> None:
        """The step's outputs: the live storages among them that are not
        arguments (an input updated in place is an argument)."""
        seen = set()
        for t in _tensors(tree):
            key = id(t.untyped_storage())
            if key in self._live and key not in seen:
                seen.add(key)
                self.out_bytes += self._live[key]

    def _freed(self, key: int) -> None:
        n = self._live.pop(key, 0)
        self.live_bytes -= n

    def _track(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            key = id(st)
            if key in self._live or key in self._arg_storages:
                continue
            n = st.nbytes()
            self._live[key] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._freed, key)

    # -- ops --------------------------------------------------------------
    def _collective(self, name: str, args) -> None:
        op = _COLL.get(name)
        if op is None:
            return
        g = _group_size(args)
        if name in ("_allgather_base_", "_reduce_scatter_base_"):
            s = _nbytes(args[0])                  # the result
        elif name in ("allgather_", "allgather_into_tensor_coalesced_",
                      "reduce_scatter_", "reduce_scatter_tensor_coalesced_"):
            s = sum(_nbytes(t) for t in _tensors(args[0]))
        elif name == "alltoall_base_":
            s = _nbytes(args[1])
        elif name == "alltoall_":
            s = sum(_nbytes(t) for t in _tensors(args[1]))
        else:                                     # allreduce*, send
            s = sum(_nbytes(t) for t in _tensors(args[0]))
        if g <= 1 or not s:
            return
        w = wire_bytes(op, g, s)
        self.wire_bytes += w
        d = self.by_op.setdefault(op, {"count": 0.0, "wire_bytes": 0.0})
        d["count"] += 1
        d["wire_bytes"] += w

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        name = packet.__name__
        if func.namespace == "c10d":
            self._collective(name, args)
        if not (func.is_view or name in _NO_TRAFFIC):
            seen = {}
            for t in _tensors((args, kwargs, out)):
                seen[id(t)] = t
            self.hbm_bytes += sum(_nbytes(t) for t in seen.values())
        self._track(out)
        return out

    def memory_analysis(self) -> Dict[str, int]:
        """The reference's ``memory_analysis`` keys: the arguments, the
        outputs the step made, and the peak of the rest."""
        return {"argument_size_in_bytes": int(self.arg_bytes),
                "output_size_in_bytes": int(self.out_bytes),
                "temp_size_in_bytes": int(max(self.peak_bytes
                                              - self.out_bytes, 0))}


# ---------------------------------------------------------------------------
# AllReduce algorithm predictor — the alpha-beta model behind topo_tuner
# ---------------------------------------------------------------------------

# the parameters topo_tuner's thresholds were fitted to ("ring at/above
# 64 KiB × n_ranks", policies/mesh.py): a 50 GB/s link and a 2 us hop.
# They are the shipped policy's, not a card's; refitting them to NVLink
# would move the ring/tree crossover the policy encodes
FITTED_LINK_BW = 50e9        # B/s per link the policy was fitted to
LINK_LATENCY_S = 2e-6        # per-hop launch/sync overhead (alpha)
INTER_NODE_PENALTY = 4.0     # NIC vs link bandwidth ratio, cross-node hops
TREE_BW_DERATE = 0.6         # halving/doubling strides use the fabric worse

ALLREDUCE_ALGOS = ("ring", "tree", "bidir_ring")


def predict_allreduce_time(algo: str, size_bytes: int, n_ranks: int, *,
                           n_nodes: int = 1,
                           link_bw: float = FITTED_LINK_BW,
                           alpha: float = LINK_LATENCY_S) -> float:
    """Alpha-beta time estimate for one AllReduce, in seconds.

    The same wire-byte formulas the trace analysis above uses
    (all-reduce moves ``2·(g-1)/g · S``), with per-algorithm latency
    terms: a ring serializes ``2·(g-1)`` hops, a halving/doubling tree
    takes ``2·log2(g)`` rounds at derated bandwidth, and ``bidir_ring``
    stands in for the hierarchical 2D schedule — intra-node rings at
    full bandwidth plus an inter-node ring over the per-node shard.
    Flat ring/tree on a multi-node mesh pay the inter-node bandwidth
    penalty on every hop (their schedules cross nodes constantly).
    """
    g = max(2, int(n_ranks))
    s = float(size_bytes)
    n_nodes = max(1, int(n_nodes))
    wire = 2.0 * (g - 1) / g * s
    cross = INTER_NODE_PENALTY if n_nodes > 1 else 1.0
    if algo == "ring":
        return 2.0 * (g - 1) * alpha + wire / (link_bw / cross)
    if algo == "tree":
        rounds = 2.0 * max(1, (g - 1).bit_length())
        return rounds * alpha + wire / (TREE_BW_DERATE * link_bw / cross)
    if algo == "bidir_ring":
        if n_nodes == 1:
            # degenerate: one node -> a plain ring with setup overhead
            return 2.0 * (g - 1) * alpha + wire / link_bw + 2.0 * alpha
        rpn = max(1, g // n_nodes)
        intra = (2.0 * (rpn - 1) * alpha +
                 2.0 * (rpn - 1) / rpn * s / link_bw)
        s_node = s / rpn
        inter = (2.0 * (n_nodes - 1) * alpha +
                 2.0 * (n_nodes - 1) / n_nodes * s_node /
                 (link_bw / INTER_NODE_PENALTY))
        return intra + inter
    raise ValueError(f"unknown allreduce algo {algo!r}; "
                     f"algos: {ALLREDUCE_ALGOS}")


def best_allreduce_algo(size_bytes: int, n_ranks: int, *,
                        n_nodes: int = 1) -> str:
    """Predictor argmin over :data:`ALLREDUCE_ALGOS` — what topo_tuner's
    thresholds are validated against (tests/test_torch_launch.py)."""
    return min(ALLREDUCE_ALGOS,
               key=lambda a: predict_allreduce_time(
                   a, size_bytes, n_ranks, n_nodes=n_nodes))


def model_flops(cfg, kind: str, batch: int, seq: int) -> float:
    """6·N·D (train) or 2·N·D (fwd) with N = active params."""
    n_active = cfg.param_count(active_only=True)
    mult = 6.0 if kind == "train" else 2.0
    tokens = batch * seq if kind != "decode" else batch * 1
    return mult * n_active * tokens


def analyze_trace(an: TraceAnalyzer, *, arch: str, shape: str, mesh: str,
                  cfg, n_devices: int, kind: str,
                  global_batch: Optional[int] = None,
                  seq_len: Optional[int] = None) -> Dict:
    """The roofline record of one analysed step: the reference's keys,
    with ``trace_*`` for its ``hlo_*`` (no compiler cost model exists to
    report beside them).  ``global_batch`` / ``seq_len`` default to the
    shape's."""
    from ..configs import SHAPES

    t_compute = an.flops / PEAK_FLOPS
    t_memory = an.hbm_bytes / HBM_BW
    t_coll = an.wire_bytes / (LINK_BW * N_LINKS)
    dominant = max((("compute", t_compute), ("memory", t_memory),
                    ("collective", t_coll)), key=lambda kv: kv[1])[0]
    sh = SHAPES.get(shape)
    batch = global_batch if global_batch is not None else sh.global_batch
    seq = seq_len if seq_len is not None else sh.seq_len
    mf_per_dev = model_flops(cfg, kind, batch, seq) / n_devices
    return {
        "arch": arch, "shape": shape, "mesh": mesh,
        "n_devices": n_devices,
        "trace_flops_per_dev": an.flops,
        "trace_bytes_per_dev": an.hbm_bytes,
        "collective_wire_bytes_per_dev": an.wire_bytes,
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "model_flops_per_dev": mf_per_dev,
        "useful_flops_ratio": mf_per_dev / an.flops if an.flops else 0.0,
        "memory_analysis": an.memory_analysis(),
        "collectives_by_op": an.by_op,
        "aten_ops": an.ops,
    }


def timed_trace(fn, arguments) -> tuple:
    """Run ``fn()`` under a fresh :class:`TraceAnalyzer` with
    ``arguments`` registered; returns ``(analyzer, output, seconds)``."""
    an = TraceAnalyzer()
    an.arguments(arguments)
    t0 = time.perf_counter()
    with an:
        out = fn()
    an.outputs(out)
    return an, out, time.perf_counter() - t0
