"""Declarative checkpoint policy: the composable public configuration.

One frozen config object per subsystem, composed into one
:class:`CheckpointPolicy`:

* :class:`EnginePolicy`  — which data-movement engine and its lane tuning;
* :class:`StoragePolicy` — where committed steps live (tiers), how many
  survive (retention), and integrity checksums;
* :class:`DistPolicy`    — the multi-rank writer world;
* :class:`DeltaPolicy`   — the differential-checkpointing chain schedule;
* a :class:`~repro_torch.core.registry.StateProviderRegistry` routing each
  state leaf to its provider.

Fields and defaults are the JAX package's. Build a manager with
``CheckpointManager.from_policy(directory, policy, device=...)``; the
deprecated flat kwargs map onto these fields through
:data:`LEGACY_KWARG_MAP` and :meth:`CheckpointPolicy.from_legacy_kwargs`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

from repro_torch.storage.repository import RetentionPolicy, Tier

from .codecs import DELTA_CODEC
from .registry import StateProviderRegistry


@dataclasses.dataclass(frozen=True)
class EnginePolicy:
    """Data-movement engine selection and lane tuning (paper §V-A)."""

    mode: str = "datastates"
    host_cache_bytes: int = 1 << 30
    flush_threads: int = 4
    chunk_bytes: int = 4 << 20
    throttle_mbps: Optional[float] = None
    restore_threads: Optional[int] = None

    def __post_init__(self):
        if self.host_cache_bytes < 1:
            raise ValueError("host_cache_bytes must be positive")
        if self.flush_threads < 1 or self.chunk_bytes < 1:
            raise ValueError("flush_threads and chunk_bytes must be >= 1")


@dataclasses.dataclass(frozen=True)
class StoragePolicy:
    """Tiered residence + retention of committed steps (repository layer):
    committed steps cascade to ``tiers`` (fast -> durable) in the
    background, and ``retention`` decides which steps the local tier
    keeps."""

    tiers: Tuple[Tier, ...] = ()
    retention: Optional[RetentionPolicy] = None
    manifest_checksums: bool = True

    def __post_init__(self):
        object.__setattr__(self, "tiers", tuple(self.tiers))


@dataclasses.dataclass(frozen=True)
class DistPolicy:
    """Multi-rank writer world: ``world`` writer ranks (or a ready
    ``coordinator``), run as threads or spawned processes (``runtime``),
    committing through nodes of ``node_size`` ranks; ``ack_timeout_s``
    arms the watchdog that fails a save whose ranks do not all ack."""

    world: Optional[int] = None
    coordinator: Optional[Any] = None
    ack_timeout_s: Optional[float] = None
    runtime: str = "thread"
    node_size: Optional[int] = None

    def __post_init__(self):
        if self.world is not None and self.world < 1:
            raise ValueError(f"world must be >= 1, got {self.world}")
        if self.runtime not in ("thread", "process"):
            raise ValueError(
                f"runtime must be 'thread' or 'process', "
                f"got {self.runtime!r}")
        if self.node_size is not None and self.node_size < 1:
            raise ValueError(
                f"node_size must be >= 1, got {self.node_size}")


@dataclasses.dataclass(frozen=True)
class DeltaPolicy:
    """Differential checkpointing on the main engine path (paper §VII).

    Every save streams XOR deltas of each delta-routed tensor against the
    previous save's retained host copy, compressed on the flush lanes —
    except a raw *keyframe* every ``keyframe_every`` saves, on the first
    save of a run, and whenever the shard set / shapes / dtypes change.
    ``verify_chain_on_restore`` re-audits every chain member (sizes +
    manifest checksums) before a chain restore, so silent corruption of a
    keyframe can never be XOR-amplified into a restored state.
    """

    keyframe_every: int = 4
    codec: str = DELTA_CODEC
    verify_chain_on_restore: bool = True

    def __post_init__(self):
        if self.keyframe_every < 1:
            raise ValueError(
                f"keyframe_every must be >= 1, got {self.keyframe_every}")


# Legacy CheckpointManager kwarg → (policy section, field) — the migration
# table in README mirrors this mapping.
LEGACY_KWARG_MAP = {
    "mode": ("engine", "mode"),
    "host_cache_bytes": ("engine", "host_cache_bytes"),
    "flush_threads": ("engine", "flush_threads"),
    "chunk_bytes": ("engine", "chunk_bytes"),
    "throttle_mbps": ("engine", "throttle_mbps"),
    "restore_threads": ("engine", "restore_threads"),
    "tiers": ("storage", "tiers"),
    "retention": ("storage", "retention"),
    "manifest_checksums": ("storage", "manifest_checksums"),
    "world": ("dist", "world"),
    "coordinator": ("dist", "coordinator"),
    "ack_timeout_s": ("dist", "ack_timeout_s"),
    "delta": (None, "delta"),
}


@dataclasses.dataclass(frozen=True)
class CheckpointPolicy:
    """The complete declarative configuration of a checkpoint manager."""

    engine: EnginePolicy = dataclasses.field(default_factory=EnginePolicy)
    storage: StoragePolicy = dataclasses.field(default_factory=StoragePolicy)
    dist: DistPolicy = dataclasses.field(default_factory=DistPolicy)
    delta: Optional[DeltaPolicy] = None
    providers: Optional[StateProviderRegistry] = None

    @classmethod
    def from_legacy_kwargs(cls, **kwargs) -> "CheckpointPolicy":
        """Build a policy from the deprecated flat-kwarg constructor
        surface. Every legacy kwarg maps onto exactly one policy field;
        unknown names raise ``TypeError`` like a normal bad kwarg."""
        sections: dict = {"engine": {}, "storage": {}, "dist": {}}
        top: dict = {}
        for name, value in kwargs.items():
            where = LEGACY_KWARG_MAP.get(name)
            if where is None:
                raise TypeError(
                    f"unknown CheckpointManager argument {name!r}")
            section, field = where
            (top if section is None else sections[section])[field] = value
        return cls(engine=EnginePolicy(**sections["engine"]),
                   storage=StoragePolicy(**sections["storage"]),
                   dist=DistPolicy(**sections["dist"]), **top)

    def replace(self, **kw) -> "CheckpointPolicy":
        return dataclasses.replace(self, **kw)
