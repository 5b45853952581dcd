"""Topology-aware AllReduce selection — the mesh-scale tuner.

``topo_tuner`` is the first policy to read the topology ctx fields
(``n_nodes`` / ``ranks_per_node``, fed by
``CollectiveDispatcher.set_topology`` from ``launch.mesh.mesh_topology``)
instead of treating the mesh as a flat rank count.  The decision
structure mirrors the alpha-beta predictor in ``launch.roofline``
(``predict_allreduce_time`` / ``best_allreduce_algo``), which is also
what the validation test checks the thresholds against:

  * **multi-node mesh** (``n_nodes >= 2``) — large messages take the
    hierarchical 2D schedule (``BIDIR_RING``: intra-node rings at full
    link bandwidth plus one inter-node ring over the per-node shard);
    small messages take the latency-bound tree.  A flat ring pays the
    inter-node bandwidth penalty on every hop, so it is never selected
    across nodes.
  * **single node** — the classic ring-vs-tree crossover.  The ring's
    latency term grows with ``2*(n-1)`` serialized hops while the
    tree's grows with ``2*log2(n)`` rounds, so the crossover size
    scales with the rank count: ring at/above ``64 KiB * n_ranks``
    (~the predictor's crossover at 8 ranks with ~15% margin), tree/LL
    below.

Channel count scales with how far above the crossover the message sits,
clamped to [2, max_channels or 16].  Non-AllReduce collectives defer —
this policy encodes AllReduce schedule structure only.
"""

from __future__ import annotations

from ..core.context import Algo, CollType, Proto
from ..core.frontend import policy

ALGO_RING = Algo.RING
ALGO_TREE = Algo.TREE
ALGO_BIDIR = Algo.BIDIR_RING
PROTO_SIMPLE = Proto.SIMPLE
PROTO_LL = Proto.LL
COLL_ALL_REDUCE = CollType.ALL_REDUCE

KiB = 1 << 10
MiB = 1 << 20

# single-node ring-vs-tree crossover per rank (see module docstring)
CROSSOVER_PER_RANK = 64 * KiB
# multi-node: below this the tree's log-depth latency wins even across
# nodes; above it the hierarchical schedule's bandwidth structure wins.
# The alpha-beta crossover scales with ranks_per_node (the intra-node
# ring's serialized hops): ~24 KiB at 4 ranks/node, ~100-150 KiB at 8 —
# 12 KiB/rank keeps every disagreement within 1.26x of the predictor's
# argmin across 2-8 nodes (see test_topo_tuner_matches_alpha_beta_predictor)
NODE_SMALL_PER_RANK = 12 * KiB


@policy(section="tuner", maps=[])
def topo_tuner(ctx):
    if ctx.coll_type != COLL_ALL_REDUCE:
        return 0                       # defer: AllReduce structure only
    if ctx.n_ranks < 2:
        return 0                       # nothing to schedule
    cap = ctx.max_channels
    if cap == 0:
        cap = 16
    if cap > 16:
        cap = 16
    if ctx.n_nodes >= 2:
        rpn = ctx.ranks_per_node
        if rpn == 0:
            rpn = 8                    # topology pair half-set: assume dense
        if ctx.msg_size >= NODE_SMALL_PER_RANK * rpn:
            ctx.algorithm = ALGO_BIDIR
            ctx.protocol = PROTO_SIMPLE
            ctx.n_channels = cap
            return 1
        ctx.algorithm = ALGO_TREE
        ctx.protocol = PROTO_LL
        ctx.n_channels = 2
        return 1
    crossover = CROSSOVER_PER_RANK * ctx.n_ranks
    if ctx.msg_size >= crossover:
        ctx.algorithm = ALGO_RING
        ctx.protocol = PROTO_SIMPLE
        # more channels the deeper into the bandwidth regime we are
        nc = 2
        if ctx.msg_size >= crossover * 4:
            nc = 4
        if ctx.msg_size >= crossover * 16:
            nc = 8
        if ctx.msg_size >= crossover * 64:
            nc = 16
        ctx.n_channels = min(nc, cap)
        return 1
    ctx.algorithm = ALGO_TREE
    ctx.protocol = PROTO_LL
    ctx.n_channels = 2
    return 1
