"""Peer-to-peer slice exchange between concurrent restorers.

The second layer of the fleet warm-start fabric, for objects too large to
funnel through one cache leader: every replica currently restoring the
same object joins the object's *swap session*, claims disjoint byte
slices (dealt by the restore engine's ranged-read planner,
:func:`repro_torch.core.restore.plan_ranged_slices`), fetches only its claimed
slices from the remote tier, and publishes them to the session's slice
table. Replicas then assemble the full object from each other's slices —
bittorrent-style — so the remote tier serves each byte once no matter how
many replicas are warming up.

Integrity: a claimer publishes each slice with its
:func:`~repro_torch.core.codecs.payload_digest`, computed on the
exchange's ``device`` (the checksum kernel on a card); every *consumer*
of an exchanged slice recomputes the digest before trusting the bytes, and a
mismatch (bit-flip in peer memory, torn publish) causes that consumer to
discard the slice and fetch it directly from the remote tier. The
repository's whole-file manifest checksum still gates final admission, so
the exchange can only ever degrade performance, never correctness.

Fault model: a peer dying mid-exchange simply stops publishing. Claims
carry a deadline; once expired, any live replica re-claims the slice and
fetches it itself, so the session degrades to plain remote reads instead
of hanging.

Locking: ``fleet.exchange`` (rank 46) guards the session table;
``fleet.session`` (rank 48, a condition per session) guards one session's
claim/slice state. Remote reads and digest computation happen outside
both; waiting happens only on the session's own condition.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis.locks import declares_lock
from repro_torch.core.codecs import payload_digest
from repro_torch.core.restore import plan_ranged_slices
from repro_torch.obs import trace as obs
from repro_torch.obs.metrics import metrics as obs_metrics
from repro_torch.storage.backend import BackendError

__all__ = ["PeerExchange", "ExchangeStats"]


def _digest(data: bytes, device: torch.device) -> int:
    """The slice's position-weighted u32 digest, computed on ``device``
    (equal to the JAX package's ``_digest`` on the same bytes)."""
    return int(payload_digest(np.frombuffer(data, dtype=np.uint8),
                              device)) if data else 0


class ExchangeStats:
    """Per-replica accounting for one exchanged object."""

    __slots__ = ("remote_bytes", "peer_bytes", "refetched_slices",
                 "reclaimed_slices", "n_slices")

    def __init__(self) -> None:
        self.remote_bytes = 0      # bytes this replica pulled from remote
        self.peer_bytes = 0        # bytes this replica got from peers
        self.refetched_slices = 0  # digest-mismatch remote refetches
        self.reclaimed_slices = 0  # expired claims this replica took over
        self.n_slices = 0


@declares_lock("fleet.session", rank=48, attrs=("_cond",))
class _SwapSession:
    """One object's swap session: slice claims and the published table."""

    def __init__(self, key: str, nbytes: int, slice_bytes: int,
                 claim_timeout_s: float):
        self.key = key
        self.nbytes = nbytes
        self.slices: List[Tuple[int, int]] = \
            plan_ranged_slices(nbytes, slice_bytes)
        self.claim_timeout_s = claim_timeout_s
        self._cond = threading.Condition()  # declared: fleet.session (r48)
        self._unclaimed: List[int] = list(range(len(self.slices)))
        self._claims: Dict[int, float] = {}   # idx -> deadline (monotonic)
        self._parts: Dict[int, Tuple[bytes, int]] = {}  # idx -> (data, dig)
        self.joined = 0

    # ------------------------------------------------------------- claiming
    def next_claim(self) -> Optional[int]:
        """Claim a slice to fetch, reclaiming expired claims; ``None``
        when every slice is published or claimed by a live peer (the
        caller should then wait for completion)."""
        with self._cond:
            while True:
                if self._unclaimed:
                    idx = self._unclaimed.pop()
                    self._claims[idx] = time.monotonic() \
                        + self.claim_timeout_s
                    return idx
                now = time.monotonic()
                expired = [i for i, dl in self._claims.items()
                           if dl <= now]
                if expired:
                    idx = expired[0]
                    self._claims[idx] = now + self.claim_timeout_s
                    return -idx - 1  # reclaim marker (same slice index)
                if len(self._parts) == len(self.slices):
                    return None
                # all outstanding claims are live: wait for a publish or
                # the nearest claim expiry, whichever is sooner
                timeout = min((dl - now for dl in self._claims.values()),
                              default=0.05)
                self._cond.wait(timeout=max(0.01, min(timeout, 0.5)))

    def publish(self, idx: int, data: bytes, digest: int) -> None:
        with self._cond:
            self._parts[idx] = (data, digest)
            self._claims.pop(idx, None)
            self._cond.notify_all()

    def abandon(self, idx: int) -> None:
        """Give a failed claim back (the claimer's remote read raised)."""
        with self._cond:
            if idx not in self._parts:
                self._claims.pop(idx, None)
                self._unclaimed.append(idx)
                self._cond.notify_all()

    def complete(self) -> bool:
        with self._cond:
            return len(self._parts) == len(self.slices)

    def part(self, idx: int) -> Optional[Tuple[bytes, int]]:
        with self._cond:
            return self._parts.get(idx)


@declares_lock("fleet.exchange", rank=46, attrs=("_lock",))
class PeerExchange:
    """Swap-session broker shared by every replica in the process;
    ``device`` is where slice digests are computed."""

    def __init__(self, slice_bytes: int = 4 << 20,
                 claim_timeout_s: float = 5.0, *,
                 device: torch.device = "cuda"):
        self.device = torch.device(device)
        self.slice_bytes = int(slice_bytes)
        self.claim_timeout_s = float(claim_timeout_s)
        self._lock = threading.Lock()  # declared: fleet.exchange (r46)
        self._sessions: Dict[str, _SwapSession] = {}

    def _session(self, key: str, nbytes: int) -> _SwapSession:
        with self._lock:
            sess = self._sessions.get(key)
            if sess is None or sess.nbytes != nbytes:
                sess = _SwapSession(key, nbytes, self.slice_bytes,
                                    self.claim_timeout_s)
                self._sessions[key] = sess
            sess.joined += 1
            return sess

    def discard(self, key: str) -> None:
        """Drop a finished session so its slice table can be collected
        (late arrivals after a discard simply start a fresh session)."""
        with self._lock:
            self._sessions.pop(key, None)

    # ------------------------------------------------------------------ fetch
    def fetch(self, key: str, nbytes: int,
              read_range: Callable[[int, int], bytes],
              stats: Optional[ExchangeStats] = None) -> bytes:
        """Assemble ``key`` (``nbytes`` long) cooperatively.

        ``read_range(offset, n)`` reads one remote slice. The calling
        replica claims and fetches unclaimed slices until none remain,
        then assembles the object from the session table, verifying the
        publisher's digest on every slice it did not fetch itself and
        falling back to a direct remote read for any slice that fails
        verification."""
        stats = stats if stats is not None else ExchangeStats()
        sess = self._session(key, nbytes)
        stats.n_slices = len(sess.slices)
        t0 = time.perf_counter()
        own = self._contribute(sess, read_range, stats)
        data = self._assemble(sess, read_range, stats, own)
        obs.add_span("fleet.swap", t0, time.perf_counter(),
                     lane="fleet.swap", key=key, bytes=nbytes,
                     remote_bytes=stats.remote_bytes,
                     peer_bytes=stats.peer_bytes,
                     slices=stats.n_slices)
        obs_metrics.inc("fleet.remote_bytes", stats.remote_bytes)
        obs_metrics.inc("fleet.peer_bytes", stats.peer_bytes)
        return data

    def _contribute(self, sess: _SwapSession,
                    read_range: Callable[[int, int], bytes],
                    stats: ExchangeStats) -> set:
        """Claim-fetch-publish until the session has every slice; returns
        the slice indices this replica fetched itself."""
        own: set = set()
        while True:
            claim = sess.next_claim()
            if claim is None:
                return own
            idx = claim if claim >= 0 else -claim - 1
            if claim < 0:
                stats.reclaimed_slices += 1
            off, nb = sess.slices[idx]
            try:
                data = read_range(off, nb)
            except (BackendError, OSError):
                sess.abandon(idx)
                raise
            if len(data) != nb:
                sess.abandon(idx)
                raise BackendError(
                    f"{sess.key}: remote returned {len(data)} B for slice "
                    f"[{off}:{off + nb})")
            stats.remote_bytes += nb
            own.add(idx)
            sess.publish(idx, data, _digest(data, self.device))

    def _assemble(self, sess: _SwapSession,
                  read_range: Callable[[int, int], bytes],
                  stats: ExchangeStats, own: set) -> bytes:
        """Stitch the replica's copy together from the session table."""
        parts: List[bytes] = []
        for idx, (off, nb) in enumerate(sess.slices):
            entry = sess.part(idx)
            data: Optional[bytes] = None
            exchanged = idx not in own
            if entry is not None:
                data, digest = entry
                if exchanged and (len(data) != nb
                                  or _digest(data, self.device) != digest):
                    data = None  # corrupt exchange: fall back to remote
                    stats.refetched_slices += 1
            if data is None:
                data = read_range(off, nb)
                if len(data) != nb:
                    raise BackendError(
                        f"{sess.key}: remote returned {len(data)} B for "
                        f"slice [{off}:{off + nb})")
                stats.remote_bytes += nb
            elif exchanged:
                stats.peer_bytes += nb
            parts.append(data)
        return b"".join(parts)
