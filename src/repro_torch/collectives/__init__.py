"""Cost model and policy-driven decisions for collectives.

Every collective consults the verified tuner chain through
:class:`CollectiveDispatcher.decide`, exactly like NCCL's getCollInfo
consults a tuner plugin.  The collective algorithms and their entry
points are not ported yet; the decision plane is.
"""

from .cost_model import CostModel, NVLINK_B300, TPU_V5E
from .dispatch import (CollectiveDispatcher, Decision, DispatchConfig,
                       dispatcher, reset_dispatcher)

__all__ = [
    "CostModel", "TPU_V5E", "NVLINK_B300", "CollectiveDispatcher",
    "Decision", "DispatchConfig", "dispatcher", "reset_dispatcher",
]
