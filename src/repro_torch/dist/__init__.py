"""Multi-rank checkpoint coordination (N-writer world).

See :mod:`repro_torch.dist.coordinator` for the save protocol (balanced
writer partition → per-rank engine lanes → phase-1 rank-manifest votes →
hierarchical node→global ack collective → phase-2 global commit),
:mod:`repro_torch.dist.barrier` for the failure-aware collective
primitive underneath it, and :mod:`repro_torch.dist.process_runtime` for
the process-per-rank backend (``runtime="process"``) where a dead rank
is a dead OS process, SIGKILL and all.
"""

from .barrier import BarrierBroken, CollectiveBarrier
from .coordinator import (Coordinator, DEFAULT_NODE_SIZE, FAULT_POINTS,
                          RANK_ENGINES, RUNTIME_KINDS, ThreadRankRuntime,
                          node_topology, partition_records)
from .ipc import (PROCESS_FAULT_POINTS, ProcessDied, ProcessFaultSpec,
                  RemoteRankError)
from .runtime import BaseRankRuntime

__all__ = [
    "BarrierBroken", "BaseRankRuntime", "CollectiveBarrier",
    "Coordinator", "DEFAULT_NODE_SIZE", "FAULT_POINTS",
    "PROCESS_FAULT_POINTS", "ProcessDied", "ProcessFaultSpec",
    "RANK_ENGINES", "RUNTIME_KINDS", "RemoteRankError",
    "ThreadRankRuntime", "node_topology", "partition_records",
]
