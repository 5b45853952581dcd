"""Typed context structs passed to policy programs (the r1 argument).

Mirrors NCCLbpf's ``policy_context`` / ``profiler_context``: fixed-layout
structs with *input* (read-only) and *output* (read-write) fields.  The
verifier enforces field permissions and bounds; writing an input field is
one of the paper's seven rejected bug classes.

All fields are 8-byte slots (u64) for simplicity of layout; the frontends
expose them by name.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple


@dataclasses.dataclass(frozen=True)
class Field:
    name: str
    offset: int
    size: int
    writable: bool


class CtxType:
    def __init__(self, name: str, fields: List[Tuple[str, bool]]):
        self.name = name
        self.fields: Dict[str, Field] = {}
        off = 0
        for fname, writable in fields:
            self.fields[fname] = Field(fname, off, 8, writable)
            off += 8
        self.size = off

    def field_at(self, offset: int, size: int) -> Field:
        """Return the field covering [offset, offset+size) or raise."""
        for f in self.fields.values():
            if f.offset == offset and size <= f.size:
                return f
        raise KeyError(f"{self.name}: no field at offset {offset} size {size}")

    def offset_of(self, name: str) -> int:
        return self.fields[name].offset

    def __repr__(self) -> str:
        return f"CtxType({self.name}, {len(self.fields)} fields, {self.size}B)"


# --- Tuner: the getCollInfo analogue -------------------------------------
# Inputs describe the collective call; outputs are the policy's decision.
# algorithm/protocol/n_channels mirror NCCL tuner v3; the cost_table
# translation happens in the dispatch layer (tuner v5 style).
POLICY_CONTEXT = CtxType(
    "policy_context",
    [
        # inputs (read-only)
        ("coll_type", False),     # CollType enum value
        ("msg_size", False),      # bytes
        ("n_ranks", False),       # devices participating
        ("comm_id", False),       # stable communicator hash
        ("axis_kind", False),     # AxisKind enum (data/model/pod/expert)
        ("dtype_bytes", False),   # element size of the operand
        ("max_channels", False),  # clamp supplied by the framework
        ("topo_links", False),    # ICI links per chip on this axis
        # outputs (read-write)
        ("algorithm", True),
        ("protocol", True),
        ("n_channels", True),
        # topology inputs (read-only) — appended AFTER the outputs so
        # every pre-existing field keeps its offset (compiled programs
        # bake offsets in).  Fed from launch/mesh.py::mesh_topology via
        # CollectiveDispatcher.set_topology; both default to 0 = unknown
        # (policies treat 0 ranks_per_node as "all ranks on one node").
        ("n_nodes", False),        # distinct hosts/processes in the mesh
        ("ranks_per_node", False),  # ranks co-located per host
    ],
)

# --- Profiler: event callback analogue ------------------------------------
PROFILER_CONTEXT = CtxType(
    "profiler_context",
    [
        ("event_type", False),    # ProfEvent enum
        ("coll_type", False),
        ("msg_size", False),
        ("comm_id", False),
        ("latency_ns", False),
        ("n_channels", False),
        ("algorithm", False),
        ("timestamp_ns", False),
    ],
)

# --- Net: per-issue data-plane hook ---------------------------------------
NET_CONTEXT = CtxType(
    "net_context",
    [
        ("op", False),            # 0=isend 1=irecv
        ("bytes", False),
        ("peer", False),
        ("comm_id", False),
        ("conn_id", False),
    ],
)

# --- Env: init-time runtime-parameter hook (NCCL env plugin) ---------------
ENV_CONTEXT = CtxType(
    "env_context",
    [
        # inputs: deployment topology
        ("n_devices", False),
        ("tp", False),
        ("dp", False),
        ("n_pods", False),
        ("topo_links", False),
        # outputs: framework defaults (0 = keep built-in)
        ("default_algorithm", True),
        ("default_protocol", True),
        ("default_channels", True),
        ("max_channels", True),
    ],
)

CTX_TYPES = {
    "tuner": POLICY_CONTEXT,
    "profiler": PROFILER_CONTEXT,
    "net": NET_CONTEXT,
    "env": ENV_CONTEXT,
}


# --- Enums shared with the collectives layer -------------------------------

class CollType:
    ALL_REDUCE = 0
    ALL_GATHER = 1
    REDUCE_SCATTER = 2
    ALL_TO_ALL = 3
    BROADCAST = 4
    PPERMUTE = 5

    NAMES = {0: "all_reduce", 1: "all_gather", 2: "reduce_scatter",
             3: "all_to_all", 4: "broadcast", 5: "ppermute"}


class Algo:
    DEFAULT = 0   # XLA-native lowering (psum / all_to_all) — the NVLS analogue
    RING = 1
    TREE = 2      # recursive halving/doubling
    BIDIR_RING = 3

    NAMES = {0: "default", 1: "ring", 2: "tree", 3: "bidir_ring"}
    COUNT = 4


class Proto:
    SIMPLE = 0    # f32 wire, bandwidth-optimal
    LL = 1        # bf16 wire (latency-optimized analogue)
    LL128 = 2     # bf16 wire, f32 accumulation

    NAMES = {0: "simple", 1: "ll", 2: "ll128"}
    COUNT = 3


class AxisKind:
    DATA = 0
    MODEL = 1
    POD = 2
    EXPERT = 3

    NAMES = {0: "data", 1: "model", 2: "pod", 3: "expert"}


class ProfEvent:
    COLL_BEGIN = 0
    COLL_END = 1
    STEP_END = 2


class PolicyContextValues:
    """Concrete runtime value for POLICY_CONTEXT, backed by a bytearray."""

    __slots__ = ("buf", "ctx_type")

    def __init__(self, ctx_type: CtxType = POLICY_CONTEXT, **kwargs):
        self.ctx_type = ctx_type
        self.buf = bytearray(ctx_type.size)
        for k, v in kwargs.items():
            self[k] = v

    def __getitem__(self, name: str) -> int:
        f = self.ctx_type.fields[name]
        return int.from_bytes(self.buf[f.offset:f.offset + 8], "little", signed=False)

    def __setitem__(self, name: str, value: int) -> None:
        f = self.ctx_type.fields[name]
        self.buf[f.offset:f.offset + 8] = (int(value) & ((1 << 64) - 1)).to_bytes(8, "little")

    def as_dict(self) -> dict:
        return {k: self[k] for k in self.ctx_type.fields}


def make_ctx(kind: str, **kwargs) -> PolicyContextValues:
    return PolicyContextValues(CTX_TYPES[kind], **kwargs)
