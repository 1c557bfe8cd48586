"""Rank-runtime interface shared by the thread and process backends.

A *rank runtime* is one writer rank of the coordinator's world: it owns a
private engine + host-cache lane, drains the shard records assigned to
it, casts its phase-1 vote, and meets the ack collective through the
:class:`~repro_torch.dist.coordinator._SaveJob` callbacks. Two backends
implement the interface:

* ``ThreadRankRuntime`` (``dist.coordinator``) — a thread in this
  process. Deterministic, cheap, and fault-injectable with closures:
  the test double every protocol test runs against.
* ``ProcessRankRuntime`` (``dist.process_runtime``) — a spawned child
  process per rank, the real isolation domain: a SIGKILL kills exactly
  one rank, the way a node loss would on a cluster.

This module holds the pieces both backends (and the child-side worker)
need without importing the coordinator, so ``worker.py`` can be imported
by a spawned child without dragging the whole protocol module in first.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from repro_torch.core.baselines import DataStatesEngine, DataStatesOldEngine

#: Engine classes a rank lane may run. Coordinator ranks need a
#: DataMovementEngine-family engine (own host cache + flush lanes).
RANK_ENGINES = {
    "datastates": DataStatesEngine,
    "datastates-old": DataStatesOldEngine,
}


class BaseRankRuntime:
    """Interface every rank backend implements (see module docstring)."""

    rank: int
    world: int
    lane: str

    #: The thread backend exposes its engine's host cache for tests and
    #: benchmarks; process backends have no in-process cache to expose.
    host_cache: Optional[Any] = None

    def submit(self, job: Any, records: List[Any],
               objects: Dict[str, Any], delta: Optional[Any] = None) -> None:
        """Enqueue one save's partition for this rank (non-blocking)."""
        raise NotImplementedError

    def alive(self) -> bool:
        """False once the rank's execution domain is gone (process died).

        The coordinator polls this before partitioning a save so a rank
        that died *between* saves is evicted from the writer set without
        waiting for a watchdog timeout.
        """
        return True

    def drain(self) -> None:
        """Block until every submitted save has left this rank's queue."""
        raise NotImplementedError

    def close(self) -> None:
        """Tear the rank down (idempotent; never raises on a dead rank)."""
        raise NotImplementedError
