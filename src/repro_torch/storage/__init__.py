"""Checkpoint residence: the catalog-backed repository (local tier), its
manifests and the streaming file checksum."""

from .backend import BackendError, LocalBackend, StorageBackend
from .file_format import StreamingFileChecksum
from .manifest import (CHECKSUM_ALGO, CHECKSUM_CHUNK_BYTES, FileEntry,
                       ManifestError, StepManifest, file_checksum)
from .repository import CheckpointRepository, VerifyResult, committed_steps

__all__ = [
    "BackendError", "LocalBackend", "StorageBackend",
    "StreamingFileChecksum",
    "CHECKSUM_ALGO", "CHECKSUM_CHUNK_BYTES", "FileEntry", "ManifestError",
    "StepManifest", "file_checksum",
    "CheckpointRepository", "VerifyResult", "committed_steps",
]
