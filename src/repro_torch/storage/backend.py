"""Pluggable storage backends for the tiered checkpoint repository.

A backend is a flat key->blob namespace (keys use ``/`` separators). Three
implementations cover the tiers the repository cares about:

* :class:`LocalBackend` — POSIX directory tree. Every ``put`` is atomic
  (temp file + ``os.replace``), so a control object (catalog entry, pin
  file) is visible iff it is complete, even across a crash.
* :class:`MemoryBackend` — an in-memory peer tier (a peer node's RAM)
  with an optional capacity bound.
* :class:`ObjectStoreBackend` — a simulated object store (S3-style): flat
  keys, multipart upload for large blobs, and configurable per-request
  latency plus bandwidth on one shared pipe. Objects become visible only
  at ``complete_multipart`` / ``put`` time — never partially.

All backends are thread-safe: the cascade flusher writes from a background
thread while restores may read concurrently. They are plain host code;
nothing here touches a device.
"""

from __future__ import annotations

import os
import shutil
import threading
import time
import uuid
from typing import Callable, Dict, List, Optional, Tuple

DEFAULT_PART_BYTES = 8 << 20


class BackendError(RuntimeError):
    """A storage-tier operation failed (missing key, capacity, bad upload)."""


class StorageBackend:
    """Abstract flat key→blob store; the unit the repository tiers over."""

    name = "base"
    supports_multipart = False

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

    # -- ranged reads --------------------------------------------------------
    def get_range(self, key: str, offset: int, nbytes: int) -> bytes:
        """Read ``nbytes`` of ``key`` starting at ``offset`` (slice
        semantics: short reads past EOF return the available tail).

        The fleet fabric's peer exchange is built on this — each replica
        pulls a disjoint slice of a shard file — so real tiers override
        the whole-blob fallback with a byte-accurate path (``pread``, HTTP
        ``Range``)."""
        return self.get(key)[offset:offset + nbytes]

    # -- file helpers (override where a cheaper path exists) -----------------
    def put_file(self, key: str, path: str,
                 part_bytes: int = DEFAULT_PART_BYTES) -> int:
        """Upload a local file; returns bytes transferred."""
        with open(path, "rb") as f:
            data = f.read()
        self.put(key, data)
        return len(data)

    def get_file(self, key: str, path: str) -> int:
        """Download ``key`` into ``path`` (atomic); returns bytes."""
        data = self.get(key)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        atomic_write(path, data)
        return len(data)

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


    def get_range(self, key: str, offset: int, nbytes: int) -> bytes:
        try:
            with open(self._path(key), "rb") as f:
                f.seek(offset)
                return f.read(nbytes)
        except FileNotFoundError as exc:
            raise BackendError(f"no such key {key!r}") from exc

    def put_file(self, key: str, path: str,
                 part_bytes: int = DEFAULT_PART_BYTES) -> int:
        dst = self._path(key)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        _atomic_copy(path, dst)
        return os.path.getsize(dst)

    def get_file(self, key: str, path: str) -> int:
        src = self._path(key)
        if not os.path.isfile(src):
            raise BackendError(f"no such key {key!r}")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        _atomic_copy(src, path)
        return os.path.getsize(path)


def publish_dir(staging: str, path: str) -> None:
    """Move a fully written and verified ``staging`` directory to ``path``
    in one rename, replacing whatever directory was there: the publish
    step of a re-hydrated checkpoint step."""
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.replace(staging, path)


def _atomic_copy(src: str, dst: str) -> None:
    """Copy ``src`` over ``dst`` whole or not at all (the temp sibling of
    :func:`atomic_write`)."""
    head, name = os.path.split(dst)
    tmp = os.path.join(
        head, f".{name}.tmp-{os.getpid()}-{uuid.uuid4().hex[:8]}")
    shutil.copyfile(src, tmp)
    os.replace(tmp, dst)


# ---------------------------------------------------------------------------
class MemoryBackend(StorageBackend):
    """In-memory peer tier (a peer node's RAM) with an optional capacity."""

    name = "memory"

    def __init__(self, capacity_bytes: Optional[int] = None):
        self.capacity = capacity_bytes
        self._blobs: Dict[str, bytes] = {}
        self._lock = threading.Lock()

    def used_bytes(self) -> int:
        with self._lock:
            return sum(len(b) for b in self._blobs.values())

    def put(self, key: str, data: bytes) -> None:
        data = bytes(data)
        with self._lock:
            if self.capacity is not None:
                used = sum(len(b) for k, b in self._blobs.items() if k != key)
                if used + len(data) > self.capacity:
                    raise BackendError(
                        f"memory tier full: {used + len(data)} B would "
                        f"exceed capacity {self.capacity} B")
            self._blobs[key] = data

    def get(self, key: str) -> bytes:
        with self._lock:
            try:
                return self._blobs[key]
            except KeyError as exc:
                raise BackendError(f"no such key {key!r}") from exc

    def delete(self, key: str) -> None:
        with self._lock:
            self._blobs.pop(key, None)

    def exists(self, key: str) -> bool:
        with self._lock:
            return key in self._blobs

    def list(self, prefix: str = "") -> List[str]:
        with self._lock:
            return sorted(k for k in self._blobs if k.startswith(prefix))

    def size(self, key: str) -> int:
        return len(self.get(key))

    def get_range(self, key: str, offset: int, nbytes: int) -> bytes:
        with self._lock:
            try:
                return self._blobs[key][offset:offset + nbytes]
            except KeyError as exc:
                raise BackendError(f"no such key {key!r}") from exc


# ---------------------------------------------------------------------------
class ObjectStoreBackend(StorageBackend):
    """Simulated object store: multipart upload + latency/bandwidth model.

    ``latency_s`` is added to every request (the per-request round trip of a
    remote store); ``bandwidth_mbps`` throttles payload transfer in both
    directions. Both default to "free".

    The bandwidth model is a **shared pipe**: concurrent requests split the
    configured bandwidth, they do not each get a private copy of it. Each
    transfer reserves the next window on a single pipe timeline (a
    monotonic high-water mark advanced under the lock), so N concurrent
    readers of one checkpoint collectively finish no sooner than
    ``total_bytes / bandwidth``. Latency stays per-request (round trips
    overlap across connections; bytes on the wire do not).
    """

    name = "object"
    supports_multipart = True

    def __init__(self, latency_s: float = 0.0,
                 bandwidth_mbps: Optional[float] = None,
                 part_bytes: int = DEFAULT_PART_BYTES):
        self.latency_s = latency_s
        self.bandwidth_mbps = bandwidth_mbps
        self.part_bytes = int(part_bytes)
        self._blobs: Dict[str, bytes] = {}
        self._uploads: Dict[str, Tuple[str, Dict[int, bytes]]] = {}
        self._lock = threading.Lock()
        self._pipe_free_at = 0.0  # monotonic time the shared pipe drains
        self.stats = {"n_requests": 0, "bytes_in": 0, "bytes_out": 0,
                      "n_multipart": 0}

    # -- simulation ----------------------------------------------------------
    def _simulate(self, nbytes: int, direction: str) -> None:
        done_at = None
        with self._lock:
            self.stats["n_requests"] += 1
            self.stats["bytes_in" if direction == "in" else "bytes_out"] \
                += nbytes
            if self.bandwidth_mbps and nbytes:
                # reserve this transfer's slot on the shared pipe; the
                # sleep itself happens outside the lock
                start = max(time.monotonic(), self._pipe_free_at)
                self._pipe_free_at = start \
                    + nbytes / (self.bandwidth_mbps * 1e6)
                done_at = self._pipe_free_at
        if done_at is not None:
            delay = (done_at - time.monotonic()) + self.latency_s
        else:
            delay = self.latency_s
        if delay > 0:
            time.sleep(delay)

    # -- blob API ------------------------------------------------------------
    def put(self, key: str, data: bytes) -> None:
        data = bytes(data)
        self._simulate(len(data), "in")
        with self._lock:
            self._blobs[key] = data

    def get(self, key: str) -> bytes:
        with self._lock:
            blob = self._blobs.get(key)
        if blob is None:
            self._simulate(0, "out")
            raise BackendError(f"no such key {key!r}")
        self._simulate(len(blob), "out")
        return blob

    def delete(self, key: str) -> None:
        self._simulate(0, "in")
        with self._lock:
            self._blobs.pop(key, None)

    def exists(self, key: str) -> bool:
        self._simulate(0, "out")
        with self._lock:
            return key in self._blobs

    def list(self, prefix: str = "") -> List[str]:
        self._simulate(0, "out")
        with self._lock:
            return sorted(k for k in self._blobs if k.startswith(prefix))

    def size(self, key: str) -> int:
        with self._lock:
            try:
                return len(self._blobs[key])
            except KeyError as exc:
                raise BackendError(f"no such key {key!r}") from exc

    def get_range(self, key: str, offset: int, nbytes: int) -> bytes:
        """HTTP ``Range``-style partial GET: only the requested slice
        crosses the (simulated) wire — the fleet's peer exchange depends
        on this being byte-accurate."""
        with self._lock:
            blob = self._blobs.get(key)
        if blob is None:
            self._simulate(0, "out")
            raise BackendError(f"no such key {key!r}")
        part = blob[offset:offset + nbytes]
        self._simulate(len(part), "out")
        return part

    # -- multipart upload ----------------------------------------------------
    def initiate_multipart(self, key: str) -> str:
        self._simulate(0, "in")
        upload_id = uuid.uuid4().hex
        with self._lock:
            self._uploads[upload_id] = (key, {})
            self.stats["n_multipart"] += 1
        return upload_id

    def upload_part(self, upload_id: str, part_number: int,
                    data: bytes) -> None:
        data = bytes(data)
        self._simulate(len(data), "in")
        with self._lock:
            if upload_id not in self._uploads:
                raise BackendError(f"unknown upload {upload_id!r}")
            self._uploads[upload_id][1][part_number] = data

    def complete_multipart(self, upload_id: str) -> None:
        """Assemble parts in part-number order; the key becomes visible
        only now — an aborted/crashed upload never surfaces a partial
        object."""
        self._simulate(0, "in")
        with self._lock:
            try:
                key, parts = self._uploads.pop(upload_id)
            except KeyError as exc:
                raise BackendError(f"unknown upload {upload_id!r}") from exc
            if not parts:
                raise BackendError(f"upload {upload_id!r} has no parts")
            self._blobs[key] = b"".join(parts[i] for i in sorted(parts))

    def abort_multipart(self, upload_id: str) -> None:
        self._simulate(0, "in")
        with self._lock:
            self._uploads.pop(upload_id, None)

    # -- file helpers --------------------------------------------------------
    def put_file(self, key: str, path: str,
                 part_bytes: Optional[int] = None) -> int:
        part = int(part_bytes or self.part_bytes)
        total = os.path.getsize(path)
        if total <= part:
            return super().put_file(key, path)
        upload_id = self.initiate_multipart(key)
        try:
            with open(path, "rb") as f:
                n = 0
                while True:
                    chunk = f.read(part)
                    if not chunk:
                        break
                    self.upload_part(upload_id, n, chunk)
                    n += 1
            self.complete_multipart(upload_id)
        except BaseException:
            self.abort_multipart(upload_id)
            raise
        return total
