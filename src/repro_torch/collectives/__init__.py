"""Collective algorithms, protocols, cost model, and policy-driven dispatch.

This is the substrate the paper's policies govern: every collective the
framework emits flows through :mod:`dispatch`, which consults the verified
tuner chain exactly like NCCL's getCollInfo consults a tuner plugin, and
runs the chosen algorithm over ``torch.distributed``
(:mod:`algorithms`).  :mod:`ingraph` keeps the decision on the device.
"""

from .algorithms import (all_gather_ring, all_to_all_chunked,
                         allreduce_bidir_ring, allreduce_native,
                         allreduce_ring, allreduce_tree,
                         reduce_scatter_ring)
from .cost_model import CostModel, NVLINK_B300, TPU_V5E
from .dispatch import (CollectiveDispatcher, Decision, DispatchConfig,
                       dispatcher, reset_dispatcher)

__all__ = [
    "all_gather_ring", "all_to_all_chunked", "allreduce_bidir_ring",
    "allreduce_native", "allreduce_ring", "allreduce_tree",
    "reduce_scatter_ring", "CostModel", "TPU_V5E", "NVLINK_B300",
    "CollectiveDispatcher", "Decision", "DispatchConfig", "dispatcher",
    "reset_dispatcher",
]
