"""Performance-iteration policies (§Perf hillclimbs).

These are the *verified policies* used as optimization levers in the
roofline iterations — each targets a specific collective traffic class
via the axis_kind field NCCLbpf-style policies cannot even see (our
policy_context extends the tuner ABI with topology context).
"""

from __future__ import annotations

from ..core.context import Algo, AxisKind, Proto
from ..core.frontend import policy

ALGO_DEFAULT = Algo.DEFAULT
ALGO_RING = Algo.RING
PROTO_SIMPLE = Proto.SIMPLE
PROTO_LL = Proto.LL
PROTO_LL128 = Proto.LL128
AXIS_DATA = AxisKind.DATA
AXIS_MODEL = AxisKind.MODEL
AXIS_POD = AxisKind.POD
AXIS_EXPERT = AxisKind.EXPERT

MiB = 1 << 20


@policy(section="tuner", maps=[])
def grad_compress(ctx):
    """Gradient sync (data/pod axes) on the bf16 wire (LL protocol):
    halves f32 gradient bytes on the wire; activations/TP traffic is left
    on Simple (precision-sensitive)."""
    if ctx.axis_kind == AXIS_DATA:
        ctx.algorithm = ALGO_RING
        ctx.protocol = PROTO_LL
        ctx.n_channels = 8
        return 0
    if ctx.axis_kind == AXIS_POD:
        ctx.algorithm = ALGO_RING
        ctx.protocol = PROTO_LL
        ctx.n_channels = 16
        return 0
    return 0


@policy(section="tuner", maps=[])
def expert_chunked_a2a(ctx):
    """MoE all-to-all via chunked ppermute rings (overlappable channels)."""
    if ctx.axis_kind == AXIS_EXPERT:
        ctx.algorithm = ALGO_RING
        ctx.protocol = PROTO_SIMPLE
        ctx.n_channels = 4
        return 0
    return 0


@policy(section="tuner", maps=[])
def tpu_size_aware(ctx):
    """TPU-native analogue of ring_mid_v2: latency-optimized tree+LL for
    small messages, explicit rings mid-range, XLA-native at large."""
    if ctx.msg_size < 256 * 1024:
        ctx.algorithm = 2          # TREE
        ctx.protocol = PROTO_LL
        ctx.n_channels = 1
        return 0
    if ctx.msg_size <= 64 * MiB:
        ctx.algorithm = ALGO_RING
        ctx.protocol = PROTO_LL128
        ctx.n_channels = 16
        return 0
    return 0


@policy(section="tuner", maps=[])
def grad_compress_bidir(ctx):
    """grad_compress + counter-rotating rings on the data axis."""
    if ctx.axis_kind == AXIS_DATA or ctx.axis_kind == AXIS_POD:
        ctx.algorithm = 3          # BIDIR_RING
        ctx.protocol = PROTO_LL
        ctx.n_channels = 8
        return 0
    return 0
