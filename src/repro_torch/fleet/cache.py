"""Shared read-through cache tier with single-flight de-duplication.

The first layer of the fleet warm-start fabric: K concurrent restorers
asking for the same object cause exactly one remote read. The winner (the
*leader* of the key's flight) fetches, publishes the bytes into a shared
:class:`~repro_torch.storage.backend.MemoryBackend`, and wakes the waiters; the
waiters re-check the cache instead of issuing their own remote reads.

Capacity pressure is handled by LRU eviction: an insert that overflows the
memory tier evicts least-recently-used entries until it fits. An object
larger than the whole tier passes through *uncached* — the caller still
gets its bytes, the cache just never holds them (and concurrent readers of
such an object still collapse to one remote read via the flight table).

Failure semantics: a leader whose fetch raises wakes the waiters with
nothing published; each waiter then retries the flight (one becomes the
new leader), so a flaky remote degrades to per-caller retries instead of
deadlock.

Locking: ``fleet.cache`` (rank 44) guards only the flight table and LRU
book-keeping — dict/OrderedDict mutation, never a fetch, never a sleep.
The remote read and the event wait both happen outside the lock. Plain
host code: nothing here touches a device.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Dict, Optional

from repro_torch.analysis.locks import declares_lock
from repro_torch.obs import trace as obs
from repro_torch.obs.metrics import metrics as obs_metrics
from repro_torch.storage.backend import BackendError, MemoryBackend

__all__ = ["FleetCache"]


class _Flight:
    """One in-progress fetch: waiters block on ``event`` and read the
    leader's published ``data`` directly, so even objects too large to
    cache are fetched remotely exactly once per flight."""

    __slots__ = ("event", "data")

    def __init__(self) -> None:
        self.event = threading.Event()
        self.data: Optional[bytes] = None


@declares_lock("fleet.cache", rank=44, attrs=("_lock",))
class FleetCache:
    """Read-through byte cache over a capacity-bound memory tier."""

    def __init__(self, capacity_bytes: int = 256 << 20,
                 mem: Optional[MemoryBackend] = None):
        self._mem = mem if mem is not None \
            else MemoryBackend(capacity_bytes=capacity_bytes)
        self._lock = threading.Lock()  # declared: fleet.cache (r44)
        self._flights: Dict[str, _Flight] = {}
        self._lru: "OrderedDict[str, int]" = OrderedDict()  # key -> nbytes
        self.stats = {"hits": 0, "misses": 0, "waits": 0,
                      "remote_bytes": 0, "evictions": 0, "uncached": 0}

    # ------------------------------------------------------------------ reads
    def _cached(self, key: str) -> Optional[bytes]:
        try:
            data = self._mem.get(key)
        except BackendError:
            return None
        with self._lock:
            if key in self._lru:
                self._lru.move_to_end(key)
            self.stats["hits"] += 1
        obs_metrics.inc("fleet.cache_hits")
        return data

    def get_through(self, key: str, fetch: Callable[[], bytes]) -> bytes:
        """Bytes for ``key``: from the cache, or via exactly one concurrent
        ``fetch()`` shared by every caller currently asking for ``key``."""
        while True:
            data = self._cached(key)
            if data is not None:
                return data
            with self._lock:
                fl = self._flights.get(key)
                leader = fl is None
                if leader:
                    fl = _Flight()
                    self._flights[key] = fl
                else:
                    self.stats["waits"] += 1
            if not leader:
                fl.event.wait(timeout=60.0)
                if fl.data is not None:
                    return fl.data  # leader's bytes, shared in-process
                continue  # leader failed (or timed out): retry the flight
            try:
                with obs.span("fleet.fetch", lane="fleet.fetch", key=key):
                    data = fetch()
            except BaseException:
                with self._lock:
                    self._flights.pop(key, None)
                fl.event.set()
                raise
            self._insert(key, data)
            fl.data = data
            with self._lock:
                self._flights.pop(key, None)
                self.stats["misses"] += 1
                self.stats["remote_bytes"] += len(data)
            obs_metrics.inc("fleet.remote_bytes", len(data))
            fl.event.set()
            return data

    # ---------------------------------------------------------------- inserts
    def _insert(self, key: str, data: bytes) -> None:
        """Publish ``data`` under ``key``, evicting LRU entries on capacity
        pressure; oversized objects silently pass through uncached."""
        while True:
            try:
                self._mem.put(key, data)
            except BackendError:
                victim = None
                with self._lock:
                    for k in self._lru:
                        if k != key:
                            victim = k
                            break
                    if victim is not None:
                        self._lru.pop(victim)
                        self.stats["evictions"] += 1
                    else:
                        self.stats["uncached"] += 1
                if victim is None:
                    return  # larger than the whole tier: pass through
                self._mem.delete(victim)
                continue
            with self._lock:
                self._lru[key] = len(data)
                self._lru.move_to_end(key)
            return

    def peek(self, key: str) -> Optional[bytes]:
        """Cache-only lookup (no fetch, no flight): the fabric's fast path
        for objects that normally travel the peer-exchange route."""
        return self._cached(key)

    def offer(self, key: str, data: bytes) -> None:
        """Best-effort insert of bytes obtained elsewhere (a completed
        peer exchange): stragglers arriving after the swap session ends
        get a cache hit instead of a fresh session."""
        if not self._mem.exists(key):
            self._insert(key, data)

    # ------------------------------------------------------------------ admin
    def used_bytes(self) -> int:
        return self._mem.used_bytes()

    def invalidate(self, key: str) -> None:
        with self._lock:
            self._lru.pop(key, None)
        self._mem.delete(key)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.stats)
