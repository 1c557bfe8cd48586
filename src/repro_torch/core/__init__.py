"""DataStates-LLM core on PyTorch: composable state providers + lazy async
checkpointing, with the checkpoint kernels running on an explicit device."""

from .checkpoint import (CheckpointManager, ENGINES, latest_step,
                         resolve_device, restore_from_repository, step_dir)
from .policy import (CheckpointPolicy, DeltaPolicy, DistPolicy,
                     EnginePolicy, StoragePolicy)
from .registry import (ProviderRoute, ProviderRule, RegistryError,
                       StateProviderRegistry)
from .codecs import CodecError, DELTA_CODEC, INT8_CODEC
from .restore import RestoreEngine, RestoreError, RestoreIndex, RestoreStats
from .engine import (CheckpointError, CheckpointFuture, CheckpointStats,
                     DataMovementEngine, FilePlan)
from .host_cache import CacheFullError, HostCache, Reservation
from .layout import FileLayout, FileReader, FileWriter, TensorEntry, ObjectEntry
from .state_provider import (Chunk, CompositeStateProvider, DeltaSaveSpec,
                             DeltaStateProvider, ObjectStateProvider,
                             QuantizedStateProvider, SnapshotCache, StateProvider,
                             TensorStateProvider)
from .baselines import (BaseCheckpointEngine, DataStatesEngine,
                        DataStatesOldEngine, SnapshotThenFlushEngine,
                        SyncSerializedEngine, load_snapshot_rank,
                        load_sync_rank)
from .distributed import (ShardRecord, group_by_rank, plan_shards,
                          state_domain)
from .consolidate import consolidate_step_dir, file_count

__all__ = [
    "CheckpointManager", "ENGINES", "latest_step", "resolve_device",
    "restore_from_repository", "step_dir",
    "CheckpointPolicy", "DeltaPolicy", "DistPolicy", "EnginePolicy",
    "StoragePolicy",
    "ProviderRoute", "ProviderRule", "RegistryError",
    "StateProviderRegistry",
    "CodecError", "DELTA_CODEC", "INT8_CODEC",
    "RestoreEngine", "RestoreError", "RestoreIndex", "RestoreStats",
    "CheckpointError", "CheckpointFuture", "CheckpointStats",
    "DataMovementEngine", "FilePlan",
    "CacheFullError", "HostCache", "Reservation",
    "FileLayout", "FileReader", "FileWriter", "TensorEntry", "ObjectEntry",
    "Chunk", "CompositeStateProvider", "DeltaSaveSpec", "DeltaStateProvider",
    "ObjectStateProvider", "QuantizedStateProvider", "SnapshotCache", "StateProvider",
    "TensorStateProvider",
    "BaseCheckpointEngine", "DataStatesEngine", "DataStatesOldEngine",
    "SnapshotThenFlushEngine", "SyncSerializedEngine",
    "load_snapshot_rank", "load_sync_rank",
    "ShardRecord", "group_by_rank", "plan_shards",
    "state_domain",
    "consolidate_step_dir", "file_count",
]
