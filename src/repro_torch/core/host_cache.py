"""Pre-allocated, pre-pinned host staging cache (paper §V-A1, §V-C).

One ``torch.uint8`` pool allocated once, pinned (page-locked) when the
engine's device is a CUDA card so device-to-host copies into it run as true
asynchronous DMA, with a blocking first-fit interval allocator. Pre-allocation removes per-checkpoint alloc
overheads; the blocking behaviour implements the paper's back-pressure rule —
"if the host memory reserved for checkpointing is full, the next checkpoint
request waits for previous tensors to get evicted after they are flushed".
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis.locks import declares_lock
from repro_torch.obs import trace as obs
from repro_torch.obs.metrics import metrics as obs_metrics


class CacheFullError(RuntimeError):
    pass


class Reservation:
    """A byte range inside the cache, exposed as a zero-copy memoryview,
    numpy array or torch tensor."""

    __slots__ = ("start", "nbytes", "_cache", "_released")

    def __init__(self, start: int, nbytes: int, cache: "HostCache"):
        self.start = start
        self.nbytes = nbytes
        self._cache = cache
        self._released = False

    @property
    def view(self) -> memoryview:
        return self._cache._buf_view[self.start:self.start + self.nbytes]

    def array(self, dtype, shape) -> np.ndarray:
        """Zero-copy ndarray view over this reservation."""
        return np.frombuffer(self.view, dtype=dtype).reshape(shape)

    def tensor(self) -> torch.Tensor:
        """Zero-copy uint8 tensor view (pinned when the pool is) — the
        destination of the device-to-host copies."""
        return self._cache._buf[self.start:self.start + self.nbytes]

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._cache._free(self)


# Innermost lock of the hierarchy: reserve() may block on back-pressure,
# so nothing else may be held while other threads need the allocator.
@declares_lock("host_cache.alloc", rank=70, attrs=("_lock", "_freed"))
class HostCache:
    """Blocking first-fit allocator over one pre-allocated pinned buffer."""

    def __init__(self, capacity_bytes: int, pin_memory: bool):
        self.capacity = int(capacity_bytes)
        self.pinned = bool(pin_memory)
        # One allocation for the lifetime of the engine.
        self._buf = torch.empty(self.capacity, dtype=torch.uint8,
                                pin_memory=self.pinned)
        self._buf_view = memoryview(self._buf.numpy())
        self._lock = threading.Lock()
        self._freed = threading.Condition(self._lock)
        # Sorted list of allocated (start, end) intervals.
        self._allocated: List[Tuple[int, int]] = []
        self.peak_usage = 0
        self.total_reserved = 0  # lifetime bytes, for stats

    # -- internals -----------------------------------------------------------
    def _find_gap(self, nbytes: int) -> Optional[int]:
        prev_end = 0
        for start, end in self._allocated:
            if start - prev_end >= nbytes:
                return prev_end
            prev_end = end
        if self.capacity - prev_end >= nbytes:
            return prev_end
        return None

    def _free(self, res: Reservation) -> None:
        with self._lock:
            self._allocated.remove((res.start, res.start + res.nbytes))
            self._freed.notify_all()
            used = sum(e - s for s, e in self._allocated)
        obs_metrics.set_gauge("host_cache.used_bytes", used)
        if obs.enabled():
            obs.counter("host_cache.used_bytes", used)

    # -- public --------------------------------------------------------------
    def used_bytes(self) -> int:
        with self._lock:
            return sum(e - s for s, e in self._allocated)

    def reserve(self, nbytes: int, timeout: Optional[float] = None
                ) -> Reservation:
        """Reserve ``nbytes``; blocks until space frees up (back-pressure)."""
        nbytes = int(nbytes)
        if nbytes > self.capacity:
            raise CacheFullError(
                f"request of {nbytes} B exceeds cache capacity {self.capacity} B")
        t0 = time.perf_counter()
        with self._lock:
            while True:
                start = self._find_gap(nbytes)
                if start is not None:
                    break
                if not self._freed.wait(timeout=timeout):
                    raise CacheFullError(
                        f"timed out waiting for {nbytes} B of cache space")
            self._allocated.append((start, start + nbytes))
            self._allocated.sort()
            self.total_reserved += nbytes
            used = sum(e - s for s, e in self._allocated)
            self.peak_usage = max(self.peak_usage, used)
        # Observability happens after the allocator lock is released (the
        # obs locks rank above host_cache.alloc, but no reason to hold it).
        waited = time.perf_counter() - t0
        obs_metrics.observe("host_cache.reserve_wait_s", waited)
        obs_metrics.set_gauge("host_cache.used_bytes", used)
        if obs.enabled():
            obs.add_span("host_cache.reserve", t0, t0 + waited,
                         bytes=nbytes)
            obs.counter("host_cache.used_bytes", used)
        return Reservation(start, nbytes, self)
