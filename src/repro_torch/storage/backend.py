"""Storage backends for the checkpoint repository.

A backend is a flat key->blob namespace (keys use ``/`` separators).
:class:`LocalBackend` is the POSIX directory tier: every ``put`` is atomic
(temp file + ``os.replace``), so a control object (catalog entry, marker)
is visible iff it is complete, even across a crash. The JAX package's
in-memory peer tier and simulated object store are not yet ported.
"""

from __future__ import annotations

import os
import uuid
from typing import Callable, List, Optional


class BackendError(RuntimeError):
    """A storage-tier operation failed (missing key, capacity, bad upload)."""


class StorageBackend:
    """Abstract flat key→blob store; the unit the repository tiers over."""

    name = "base"

    # -- required primitives -------------------------------------------------
    def put(self, key: str, data: bytes) -> None:
        """Store ``data`` under ``key`` atomically (visible iff complete)."""
        raise NotImplementedError

    def get(self, key: str) -> bytes:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        """Remove ``key``; missing keys are a no-op."""
        raise NotImplementedError

    def exists(self, key: str) -> bool:
        raise NotImplementedError

    def list(self, prefix: str = "") -> List[str]:
        """All keys starting with ``prefix``, sorted."""
        raise NotImplementedError

    def size(self, key: str) -> int:
        raise NotImplementedError

    def close(self) -> None:
        pass


def atomic_write(path: str, data,
                 fsync: Optional[Callable[[int], None]] = None) -> None:
    """Write ``data`` (any buffer) to ``path`` whole or not at all: into a
    temp file, flushed (and passed to ``fsync`` if given), then moved
    over ``path`` by ``os.replace``. The temp file is a hidden sibling
    (``.<name>.tmp-<pid>-<hex>``) whose name does not start with the
    object's, so one left by a writer that died is never taken for the
    object by a listing that matches names by prefix (the offline
    reducer's ``diff_*``, a step's ``*.pkl``)."""
    head, name = os.path.split(path)
    tmp = os.path.join(
        head, f".{name}.tmp-{os.getpid()}-{uuid.uuid4().hex[:8]}")
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        if fsync is not None:
            fsync(f.fileno())
    os.replace(tmp, path)


# ---------------------------------------------------------------------------
class LocalBackend(StorageBackend):
    """POSIX directory tier: keys map to paths under ``root``."""

    name = "local"

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    def _path(self, key: str) -> str:
        path = os.path.abspath(os.path.join(self.root, key))
        if not (path == self.root or path.startswith(self.root + os.sep)):
            raise BackendError(f"key {key!r} escapes backend root")
        return path

    def put(self, key: str, data: bytes) -> None:
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        atomic_write(path, data)

    def get(self, key: str) -> bytes:
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except FileNotFoundError as exc:
            raise BackendError(f"no such key {key!r}") from exc

    def delete(self, key: str) -> None:
        path = self._path(key)
        try:
            os.unlink(path)
        except FileNotFoundError:
            return
        # prune now-empty parent directories up to (not including) root
        parent = os.path.dirname(path)
        while parent != self.root:
            try:
                os.rmdir(parent)
            except OSError:
                break
            parent = os.path.dirname(parent)

    def exists(self, key: str) -> bool:
        return os.path.isfile(self._path(key))

    def list(self, prefix: str = "") -> List[str]:
        keys = []
        for dirpath, _dirs, files in os.walk(self.root):
            for fn in files:
                rel = os.path.relpath(os.path.join(dirpath, fn), self.root)
                key = rel.replace(os.sep, "/")
                if key.startswith(prefix):
                    keys.append(key)
        return sorted(keys)

    def size(self, key: str) -> int:
        try:
            return os.path.getsize(self._path(key))
        except OSError as exc:
            raise BackendError(f"no such key {key!r}") from exc

