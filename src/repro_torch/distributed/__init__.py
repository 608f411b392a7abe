"""Runtime helpers of training: the straggler watchdog and the
heartbeat-based failure detector; the reference's sharding rules on a
mesh (:mod:`.sharding`) and the collectives between the shards of a mesh
in one process (:mod:`.collectives`)."""

from .collectives import MeshComm
from .sharding import (batch_sharding, leaf_layouts, make_lm_rules,
                       param_shardings)
from .watchdog import Heartbeat, StepWatchdog

__all__ = ["StepWatchdog", "Heartbeat", "MeshComm", "make_lm_rules",
           "param_shardings", "batch_sharding", "leaf_layouts"]
