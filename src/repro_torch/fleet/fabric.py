"""Fleet warm-start fabric: the checkpoint distribution front-end.

:class:`FleetFabric` is what serving replicas attach to a
:class:`~repro_torch.storage.repository.CheckpointRepository`
(:meth:`~repro_torch.storage.repository.CheckpointRepository.attach_fleet`):
restore resolution then routes every remote re-hydration through the
fabric instead of issuing a direct per-replica tier read. Per object the
fabric picks the cheapest source:

1. **cache** — small objects (≤ one exchange slice) go through the
   shared read-through :class:`~repro_torch.fleet.cache.FleetCache`
   (single-flight: K replicas → one remote read);
2. **peer exchange** — large objects are assembled cooperatively through
   :class:`~repro_torch.fleet.peer.PeerExchange` (each replica reads a disjoint
   slice set from remote, swaps for the rest), and the assembled bytes
   are offered back to the cache for stragglers;
3. **delta pull** — a replica already holding a step's chain prefix never
   re-reads it: chain members complete on the local tier short-circuit in
   ``resolve_for_restore`` before the fabric is consulted, so warming a
   fleet from step *k* to *k+K* transfers only the delta-chain bytes
   (``fleet.delta_pull`` spans make the saving auditable).

Whatever the source, the staged step is only published locally through
``repository.admit_fetched_step`` — the same size- + checksum-verified
atomic rename the direct tier path uses — and admission is single-flight
per step, so K replicas sharing one local tier produce one publish.

The fabric's ``device`` is where the peer exchange digests slices (the
checksum kernel on a card, the default); a fetch runs its digests on a
stream of its own (``kernels.ops.lane_stream``).

Per-step transfer accounting (remote vs. peer-exchanged bytes, cache
hits, replica count) is persisted to ``.catalog/fleet-stats.json`` for
``python -m repro_torch.storage.cli stats --fleet`` (and the JAX
package's CLI, which reads the same ledger).

Locking: ``fleet.fabric`` (rank 42) guards the admit-flight table and the
stats dict only; fetches, staging writes, and admission all run outside
it (admission acquires ``repository.state`` from a bare stack).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.analysis.locks import declares_lock
from repro_torch.kernels.ops import lane_stream
from repro_torch.obs import trace as obs
from repro_torch.storage.backend import BackendError
from repro_torch.storage.manifest import StepManifest
from repro_torch.storage.repository import (CATALOG_DIR,
                                            CheckpointRepository, Tier,
                                            catalog_key, data_key)

from .cache import FleetCache, _Flight
from .peer import ExchangeStats, PeerExchange

__all__ = ["FleetFabric", "FLEET_STATS_KEY"]

FLEET_STATS_KEY = f"{CATALOG_DIR}/fleet-stats.json"


@declares_lock("fleet.fabric", rank=42, attrs=("_lock",))
class FleetFabric:
    """Cache + peer-exchange + delta-aware transfer, behind one handle."""

    def __init__(self, cache: Optional[FleetCache] = None,
                 peers: Optional[PeerExchange] = None, *,
                 cache_bytes: int = 256 << 20,
                 slice_bytes: int = 4 << 20,
                 claim_timeout_s: float = 5.0,
                 device: torch.device = "cuda"):
        self.device = torch.device(device)
        self.cache = cache if cache is not None \
            else FleetCache(capacity_bytes=cache_bytes)
        self.peers = peers if peers is not None \
            else PeerExchange(slice_bytes=slice_bytes,
                              claim_timeout_s=claim_timeout_s,
                              device=self.device)
        self._lock = threading.Lock()  # declared: fleet.fabric (r42)
        self._admits: Dict[Tuple[str, int], _Flight] = {}
        self._step_stats: Dict[int, Dict[str, int]] = {}

    # ------------------------------------------------------------ step fetch
    def fetch_step(self, repo: CheckpointRepository,
                   step: int) -> Optional[str]:
        """Re-hydrate ``step`` into ``repo``'s local tier through the
        fabric; ``None`` when no remote tier holds the step (the caller
        falls back to its own resolution)."""
        with lane_stream(self.device):
            return self._fetch_step(repo, step)

    def _fetch_step(self, repo: CheckpointRepository,
                    step: int) -> Optional[str]:
        tier = self._tier_for(repo, step)
        if tier is None:
            return None
        stats = ExchangeStats()
        hits = [0]
        mbytes = self._cached_fetch(
            catalog_key(step),
            lambda: tier.backend.get(catalog_key(step)), stats, hits)
        manifest = StepManifest.from_json_bytes(mbytes)
        d = (manifest.meta or {}).get("delta") or {}
        is_delta = not d.get("keyframe", True)
        span = "fleet.delta_pull" if is_delta else "fleet.fetch"
        t0 = time.perf_counter()
        files: Dict[str, bytes] = {}
        for fe in manifest.files:
            files[fe.name] = self._file_bytes(tier, step, fe, stats, hits)
        sdir = self._admit(repo, step, manifest, files)
        obs.add_span(span, t0, time.perf_counter(), lane=span, step=step,
                     tier=tier.name, files=len(files),
                     remote_bytes=stats.remote_bytes,
                     peer_bytes=stats.peer_bytes,
                     cache_hits=hits[0],
                     **({"base_step": d.get("base_step")} if is_delta
                        else {}))
        with self._lock:
            st = self._step_stats.setdefault(
                step, {"remote_bytes": 0, "peer_bytes": 0,
                       "cache_hits": 0, "replicas": 0, "delta": is_delta})
            st["remote_bytes"] += stats.remote_bytes
            st["peer_bytes"] += stats.peer_bytes
            st["cache_hits"] += hits[0]
            st["replicas"] += 1
        for fe in manifest.files:  # free finished swap-session tables
            self.peers.discard(data_key(step, fe.name))
        self.persist(repo)
        return sdir

    @staticmethod
    def _tier_for(repo: CheckpointRepository,
                  step: int) -> Optional[Tier]:
        for tier in repo.remote_tiers:
            try:
                if repo.tier_has_step(tier, step):
                    return tier
            except BackendError:
                continue
        return None

    # ----------------------------------------------------------- per object
    def _cached_fetch(self, key: str, fetch: Callable[[], bytes],
                      stats: ExchangeStats, hits: list) -> bytes:
        """Cache read-through with per-replica remote-byte attribution:
        only the flight leader's fetch counts against this replica."""
        fetched = []

        def _fetch() -> bytes:
            data = fetch()
            fetched.append(len(data))
            return data

        data = self.cache.get_through(key, _fetch)
        if fetched:
            stats.remote_bytes += fetched[0]
        else:
            hits[0] += 1
        return data

    def _file_bytes(self, tier: Tier, step: int, fe: Any,
                    stats: ExchangeStats, hits: list) -> bytes:
        key = data_key(step, fe.name)
        if fe.nbytes <= self.peers.slice_bytes:
            data = self._cached_fetch(
                key, lambda: tier.backend.get(key), stats, hits)
        else:
            data = self.cache.peek(key)
            if data is not None:
                hits[0] += 1
            else:
                data = self.peers.fetch(
                    key, fe.nbytes,
                    lambda off, nb: tier.backend.get_range(key, off, nb),
                    stats)
                self.cache.offer(key, data)
        if len(data) != fe.nbytes:
            raise BackendError(
                f"fleet fabric assembled {fe.name} with {len(data)} B, "
                f"manifest says {fe.nbytes} B")
        return data

    # ------------------------------------------------------------- admission
    def _admit(self, repo: CheckpointRepository, step: int,
               manifest: StepManifest, files: Dict[str, bytes]) -> str:
        """Single-flight local publish: K replicas sharing one local tier
        stage and verify once. A failed leader wakes the waiters, and the
        next one retries with its own assembled bytes."""
        akey = (repo.root, step)
        while True:
            if repo._local_complete(step):
                return repo.step_dir(step)
            with self._lock:
                fl = self._admits.get(akey)
                leader = fl is None
                if leader:
                    fl = _Flight()
                    self._admits[akey] = fl
            if not leader:
                fl.event.wait(timeout=60.0)
                continue  # re-check local completeness (or take over)
            try:
                staging = repo.new_staging_dir(step)
                try:
                    for name, data in files.items():
                        # atomic write via the repository's own local
                        # backend (staging is repository-owned space)
                        repo._local.put(os.path.relpath(
                            os.path.join(staging, name), repo.root), data)
                    return repo.admit_fetched_step(
                        step, manifest, staging, source="fleet fabric")
                except BaseException:
                    shutil.rmtree(staging, ignore_errors=True)
                    raise
            finally:
                with self._lock:
                    self._admits.pop(akey, None)
                fl.event.set()

    # ------------------------------------------------------------ accounting
    def step_stats(self) -> Dict[int, Dict[str, int]]:
        with self._lock:
            return {s: dict(v) for s, v in self._step_stats.items()}

    def persist(self, repo: CheckpointRepository) -> None:
        """Write the per-step transfer ledger where the admin CLI can see
        it (``stats --fleet`` works on the repository alone, no fabric
        instance required)."""
        steps = self.step_stats()
        payload = json.dumps(
            {"steps": {str(s): v for s, v in sorted(steps.items())},
             "cache": self.cache.snapshot()},
            indent=2).encode()
        try:
            repo._local.put(FLEET_STATS_KEY, payload)
        except (BackendError, OSError):
            pass  # read-only local tier: the in-process ledger remains
