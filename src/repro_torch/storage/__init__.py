"""Checkpoint residence: the tiered, catalog-backed repository, its
backends (local POSIX, in-memory peer, simulated object store), manifests,
the streaming file checksum and the admin CLI (``python -m
repro_torch.storage.cli``)."""

from .backend import (BackendError, LocalBackend, MemoryBackend,
                      ObjectStoreBackend, StorageBackend)
from .file_format import StreamingFileChecksum
from .manifest import (CHECKSUM_ALGO, CHECKSUM_CHUNK_BYTES, FileEntry,
                       ManifestError, NodeManifest, RankManifest,
                       StepManifest, file_checksum, read_node_manifests,
                       read_rank_manifests)
from .repository import (CascadeEvent, CheckpointRepository, GCReport,
                         RetentionPolicy, Tier, VerifyResult,
                         committed_steps, orphan_steps)

__all__ = [
    "BackendError", "LocalBackend", "MemoryBackend", "ObjectStoreBackend",
    "StorageBackend",
    "StreamingFileChecksum",
    "CHECKSUM_ALGO", "CHECKSUM_CHUNK_BYTES", "FileEntry", "ManifestError",
    "NodeManifest", "RankManifest", "StepManifest", "file_checksum",
    "read_node_manifests", "read_rank_manifests",
    "CascadeEvent", "CheckpointRepository", "GCReport", "RetentionPolicy",
    "Tier", "VerifyResult", "committed_steps", "orphan_steps",
]
