"""Checkpoint residence: the catalog-backed repository (local tier), its
manifests and the streaming file checksum."""

from .backend import BackendError, LocalBackend, StorageBackend
from .file_format import StreamingFileChecksum
from .manifest import (CHECKSUM_ALGO, CHECKSUM_CHUNK_BYTES, FileEntry,
                       ManifestError, NodeManifest, RankManifest,
                       StepManifest, file_checksum, read_node_manifests,
                       read_rank_manifests)
from .repository import CheckpointRepository, VerifyResult, committed_steps

__all__ = [
    "BackendError", "LocalBackend", "StorageBackend",
    "StreamingFileChecksum",
    "CHECKSUM_ALGO", "CHECKSUM_CHUNK_BYTES", "FileEntry", "ManifestError",
    "NodeManifest", "RankManifest", "StepManifest", "file_checksum",
    "read_node_manifests", "read_rank_manifests",
    "CheckpointRepository", "VerifyResult", "committed_steps",
]
