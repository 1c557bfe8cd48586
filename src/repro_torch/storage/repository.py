"""Tiered checkpoint repository: catalog, cascade flush, retention GC.

Sits between the data-movement engine (which gets bytes off the device
fast) and durable storage (where those bytes live). The repository owns:

* the **catalog** — one atomically-written manifest per committed step
  under ``<root>/.catalog/``. A step is visible iff its manifest exists;
  an in-flight marker (written before any data file) distinguishes crash
  victims from legacy pre-repository directories, so ``latest_step`` can
  never select a half-written checkpoint;
* the **cascade flusher** — a background thread replicating committed
  steps from the fast local tier to remote tiers (peer memory, simulated
  object store with multipart upload), overlapped with training; a delta
  chain ships whole, its catalog object last. ``close()`` joins it;
* **retention GC** — keep-last-N / keep-every-K / pinned-step policies
  applied per tier, never deleting the newest complete step, pinned
  steps, in-flight saves, anything mid-cascade or read by a restore, or a
  chain ancestor of anything kept.

Restore resolution falls back tier-by-tier: a step GC'd from (or never
present on) the local tier is re-hydrated from the first remote tier that
holds a complete copy (or through an attached fleet fabric), its files
checksummed on the repository's ``device`` against the manifest, before
the parallel ``RestoreEngine`` reads it.

Directory, catalog, marker, pin and data-key names are the JAX package's,
so each package reads a repository or a tier the other wrote.
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import json
import logging
import os
import queue
import re
import shutil
import threading
import time
import uuid
from typing import Any, Dict, Iterable, List, Optional, Sequence, Set, Tuple

import torch

from repro_torch.analysis.locks import declares_lock
from repro_torch.kernels.ops import lane_stream
from repro_torch.obs import trace as obs
from repro_torch.obs.metrics import metrics as obs_metrics

from .backend import BackendError, LocalBackend, StorageBackend, publish_dir
from .manifest import StepManifest, file_checksum, probe_step_complete

CATALOG_DIR = ".catalog"
_STEP_RE = re.compile(r"step-(\d+)\.json$")
_MARKER_RE = re.compile(r"inflight-(\d+)$")

logger = logging.getLogger(__name__)


def step_dirname(step: int) -> str:
    return f"global_step{step}"


def entry_name(step: int) -> str:
    return f"step-{step:012d}.json"


def marker_name(step: int) -> str:
    return f"inflight-{step:012d}"


def catalog_key(step: int) -> str:
    return f"{CATALOG_DIR}/{entry_name(step)}"


def marker_key(step: int) -> str:
    return f"{CATALOG_DIR}/{marker_name(step)}"


def data_key(step: int, filename: str) -> str:
    return f"{step_dirname(step)}/{filename}"


# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RetentionPolicy:
    """Which committed steps a tier keeps (pins/newest are always kept)."""

    keep_last_n: Optional[int] = None
    keep_every_k: Optional[int] = None

    def retained(self, steps: Sequence[int]) -> Set[int]:
        steps = sorted(steps)
        if self.keep_last_n is None and self.keep_every_k is None:
            return set(steps)
        keep: Set[int] = set()
        if self.keep_last_n:
            keep.update(steps[-self.keep_last_n:])
        if self.keep_every_k:
            keep.update(s for s in steps if s % self.keep_every_k == 0)
        return keep


@dataclasses.dataclass
class Tier:
    """One storage tier: a named backend plus its retention policy."""

    name: str
    backend: StorageBackend
    retention: Optional[RetentionPolicy] = None


@dataclasses.dataclass
class VerifyResult:
    step: int
    ok: bool
    missing: List[str] = dataclasses.field(default_factory=list)
    size_mismatch: List[str] = dataclasses.field(default_factory=list)
    checksum_mismatch: List[str] = dataclasses.field(default_factory=list)
    # per-chunk localization of checksum mismatches, e.g.
    # "rank00000.dsllm: w00 raw chunk [0:4194304)"
    chunk_mismatch: List[str] = dataclasses.field(default_factory=list)

    @property
    def problems(self) -> List[str]:
        return (self.missing + [f"{n} (size)" for n in self.size_mismatch]
                + [f"{n} (checksum)" for n in self.checksum_mismatch]
                + [f"{n} (chunk)" for n in self.chunk_mismatch])


@dataclasses.dataclass
class GCReport:
    deleted_steps: List[int] = dataclasses.field(default_factory=list)
    deleted_orphans: List[int] = dataclasses.field(default_factory=list)
    remote_deleted: Dict[str, List[int]] = dataclasses.field(
        default_factory=dict)
    bytes_freed: int = 0
    seconds: float = 0.0
    dry_run: bool = False


@dataclasses.dataclass
class CascadeEvent:
    step: int
    tier: str
    nbytes: int
    t_start: float
    t_end: float

    @property
    def seconds(self) -> float:
        return self.t_end - self.t_start


# ---------------------------------------------------------------------------
# Catalog scanning (module-level so `core.checkpoint.latest_step` can stay a
# plain function over a directory, with no repository instance required).

def _dir_size(sdir: str) -> int:
    total = 0
    for dirpath, _dirs, files in os.walk(sdir):
        for fn in files:
            try:
                total += os.path.getsize(os.path.join(dirpath, fn))
            except OSError:
                pass
    return total


def scan_catalog(root: str) -> Tuple[Set[int], Set[int]]:
    """(steps with a catalog entry, steps with an in-flight marker)."""
    cdir = os.path.join(root, CATALOG_DIR)
    entries: Set[int] = set()
    markers: Set[int] = set()
    if os.path.isdir(cdir):
        for n in os.listdir(cdir):
            m = _STEP_RE.match(n)
            if m:
                entries.add(int(m.group(1)))
                continue
            m = _MARKER_RE.match(n)
            if m:
                markers.add(int(m.group(1)))
    return entries, markers


def step_dirs(root: str) -> Dict[int, str]:
    out = {}
    for d in glob.glob(os.path.join(root, "global_step*")):
        m = re.search(r"global_step(\d+)$", d)
        if m and os.path.isdir(d):
            out[int(m.group(1))] = d
    return out


def committed_steps(root: str) -> List[int]:
    """Steps eligible for resume, ascending: a catalog entry is present
    (and the data directory exists), or a legacy manifest-less directory
    without an in-flight marker passes the completeness probe."""
    entries, markers = scan_catalog(root)
    steps = []
    for step, sdir in step_dirs(root).items():
        if step in entries:
            steps.append(step)
        elif step in markers:
            continue  # crash victim: data landed, manifest never committed
        elif probe_step_complete(sdir):
            steps.append(step)  # legacy pre-repository directory
    return sorted(steps)


def orphan_steps(root: str) -> List[int]:
    """Steps with on-disk data (or a stale marker) but no catalog entry and
    no passing completeness probe — crash victims awaiting GC."""
    entries, markers = scan_catalog(root)
    dirs = step_dirs(root)
    orphans = set()
    for step, sdir in dirs.items():
        if step in entries:
            continue
        if step in markers or not probe_step_complete(sdir):
            orphans.add(step)
    # markers whose data directory never appeared (crash inside makedirs)
    orphans.update(m for m in markers
                   if m not in entries and m not in dirs)
    return sorted(orphans)


# ---------------------------------------------------------------------------
@declares_lock("repository.state", rank=40, attrs=("_lock",))
class CheckpointRepository:
    """Tiered, catalog-backed home for checkpoint steps.

    ``root`` is the fast local tier (tier 0) — the directory the engines
    write into. ``remote_tiers`` are ordered fast→durable; committed steps
    cascade to them in the background when ``auto_cascade`` is on.
    ``device`` is where verify and re-hydration compute file checksums
    (the checksum kernel on a card).
    """

    def __init__(self, root: str, remote_tiers: Sequence[Tier] = (),
                 *, device: torch.device,
                 retention: Optional[RetentionPolicy] = None,
                 checksum: bool = True, auto_cascade: bool = True,
                 auto_gc: bool = True):
        self.root = os.path.abspath(root)
        self.device = torch.device(device)
        self.remote_tiers: List[Tier] = list(remote_tiers)
        bad = [t for t in self.remote_tiers if not isinstance(t, Tier)]
        if bad:
            raise TypeError(f"remote tiers must be Tier objects, got {bad}")
        names = [t.name for t in self.remote_tiers]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tier names: {names}")
        self.retention = retention
        self.checksum = checksum
        self.auto_gc = auto_gc
        self.catalog_dir = os.path.join(self.root, CATALOG_DIR)
        try:
            os.makedirs(self.catalog_dir, exist_ok=True)
        except OSError:
            # Read-only mount (serving from a snapshot of a legacy,
            # pre-repository directory): catalog reads degrade to the
            # completeness probe; catalog writes will fail loudly.
            pass
        self._local = LocalBackend(self.root)
        self._fleet: Optional[Any] = None  # repro_torch.fleet.FleetFabric
        self._lock = threading.Lock()  # declared: repository.state (r40)
        self._active: Set[int] = set()        # begun in this process
        self._mid_cascade: Set[int] = set()
        self._reading: Dict[int, int] = {}    # restore refcounts
        self._manifest_cache: Dict[int, StepManifest] = {}
        self.cascade_log: List[CascadeEvent] = []
        self.cascade_errors: List[Tuple[int, str]] = []
        self.gc_log: List[GCReport] = []
        self._cascade_q: Optional["queue.Queue[Optional[int]]"] = None
        self._cascade_thread: Optional[threading.Thread] = None
        if self.remote_tiers and auto_cascade:
            self._cascade_q = queue.Queue()
            self._cascade_thread = threading.Thread(
                target=self._cascade_worker, daemon=True,
                name="repo-cascade")
            self._cascade_thread.start()

    # ------------------------------------------------------------- locations
    def step_dir(self, step: int) -> str:
        return os.path.join(self.root, step_dirname(step))

    def _entry_path(self, step: int) -> str:
        return os.path.join(self.catalog_dir, entry_name(step))

    def _marker_path(self, step: int) -> str:
        return os.path.join(self.catalog_dir, marker_name(step))

    def _wait_not_cascading(self, step: int) -> None:
        while True:
            with self._lock:
                if step not in self._mid_cascade:
                    return
            time.sleep(0.01)

    # ------------------------------------------------------------- lifecycle
    def begin_step(self, step: int) -> str:
        """Declare a save in flight: marker first, so a crash at any later
        point leaves an identifiable orphan. Re-saving a committed step
        retracts its catalog entry, retracts every committed delta step
        whose chain passes through it (locally and on every tier), and
        clears the old data files. A cascade of the same step still in
        flight would read files the engine is about to rewrite, so it is
        waited out first."""
        while True:
            with self._lock:
                if step not in self._mid_cascade:
                    self._active.add(step)
                    self._manifest_cache.pop(step, None)
                    break
            time.sleep(0.01)
        self._retract_delta_dependents(step)
        try:
            os.unlink(self._entry_path(step))
        except FileNotFoundError:
            pass
        self._local.put(marker_key(step), str(time.time()).encode("ascii"))
        sdir = self.step_dir(step)
        if os.path.isdir(sdir):
            shutil.rmtree(sdir)
        os.makedirs(sdir, exist_ok=True)
        return sdir

    def _retract_delta_dependents(self, step: int) -> None:
        """Turn committed delta steps that depend on ``step`` into
        invisible orphans (local catalog entry -> in-flight marker; remote
        tier copies deleted): they were XOR-encoded against the bytes
        about to be replaced. Chains only point backwards, so forward
        progress scans nothing."""
        for s in [s for s in self.steps() if s > step]:
            try:
                dependent = step in self.chain_steps(s, strict=True)
            except (BackendError, OSError, ValueError):
                dependent = True  # cannot prove independence: retract
            if not dependent:
                continue
            self._wait_not_cascading(s)
            try:
                os.unlink(self._entry_path(s))
            except FileNotFoundError:
                pass
            self._local.put(marker_key(s), str(time.time()).encode("ascii"))
            with self._lock:
                self._manifest_cache.pop(s, None)
            for tier in self.remote_tiers:
                try:
                    if self.tier_has_step(tier, s):
                        self._delete_tier_step(tier, s)
                except BackendError:
                    pass  # a tier failing deletes fails reads too; the
                    # local retraction already hides the step here

    def abort_step(self, step: int) -> None:
        """A save failed after ``begin_step``: the marker stays (the step
        is an orphan for GC), but it is no longer an *active* save."""
        with self._lock:
            self._active.discard(step)

    def commit_step(self, step: int, *, engine_mode: Optional[str] = None,
                    meta: Optional[Dict[str, Any]] = None,
                    expect_ranks: Optional[int] = None,
                    writers: Optional[Sequence[int]] = None,
                    nodes: Optional[Dict[int, Any]] = None) -> StepManifest:
        """Make a fully-persisted step visible: build its manifest (sizes +
        checksums) and write it atomically *last*; then queue its cascade
        to the remote tiers and apply retention.

        ``expect_ranks`` enables the multi-rank phase-2 gate: the manifest
        build validates every rank's phase-1 vote (see
        :meth:`StepManifest.build`) and raises instead of committing a
        partially-written step. ``writers`` narrows the expected voter
        set (a coordinator that reassigned a dead rank's shards passes
        the survivors); ``nodes`` additionally audits the hierarchical
        commit tree's node-aggregator votes."""
        sdir = self.step_dir(step)
        tb0 = time.perf_counter()
        manifest = StepManifest.build(sdir, step, device=self.device,
                                      engine_mode=engine_mode,
                                      checksum=self.checksum, meta=meta,
                                      expect_ranks=expect_ranks,
                                      writers=writers, nodes=nodes)
        if not manifest.files:
            raise BackendError(
                f"refusing to commit empty step directory {sdir!r}")
        manifest.meta["commit"] = {"build_s": time.perf_counter() - tb0}
        with obs.span("manifest.write", step=step):
            self._local.put(catalog_key(step), manifest.to_json_bytes())
        try:
            os.unlink(self._marker_path(step))
        except FileNotFoundError:
            pass
        with self._lock:
            self._active.discard(step)
            self._manifest_cache[step] = manifest
            if self._cascade_q is not None:
                self._mid_cascade.add(step)
                self._cascade_q.put(step)
        if self.auto_gc and self.retention is not None:
            self.gc()
        return manifest

    # --------------------------------------------------------------- catalog
    def steps(self) -> List[int]:
        """Committed steps across *all* tiers (a step GC'd locally but
        still held by a remote tier remains resumable via re-hydration)."""
        steps = set(committed_steps(self.root))
        for tier in self.remote_tiers:
            steps.update(self.tier_steps(tier))
        return sorted(steps)

    def local_steps(self) -> List[int]:
        return committed_steps(self.root)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def orphans(self) -> List[int]:
        with self._lock:
            active = set(self._active)
        return [s for s in orphan_steps(self.root) if s not in active]

    def manifest(self, step: int) -> StepManifest:
        with self._lock:
            cached = self._manifest_cache.get(step)
        if cached is not None:
            return cached
        m = StepManifest.from_json_bytes(self._local.get(catalog_key(step)))
        with self._lock:
            self._manifest_cache[step] = m
        return m

    def has_manifest(self, step: int) -> bool:
        return os.path.isfile(self._entry_path(step))

    def manifest_any_tier(self, step: int) -> StepManifest:
        """Manifest from the local catalog, else the first remote tier
        holding the step (a chain base GC'd locally is still a chain
        base — its metadata must stay reachable)."""
        try:
            return self.manifest(step)
        except (BackendError, OSError, ValueError):
            for tier in self.remote_tiers:
                try:
                    if self.tier_has_step(tier, step):
                        m = StepManifest.from_json_bytes(
                            tier.backend.get(catalog_key(step)))
                        with self._lock:
                            self._manifest_cache[step] = m
                        return m
                except (BackendError, OSError, ValueError):
                    continue
            raise

    # ----------------------------------------------------------- delta chains
    def delta_base(self, step: int) -> Optional[int]:
        """Base step of a differential step, or None for keyframes / full
        snapshots / steps without readable chain metadata."""
        try:
            m = self.manifest_any_tier(step)
        except (BackendError, OSError, ValueError):
            return None
        d = (m.meta or {}).get("delta") or {}
        if d.get("keyframe", True):
            return None
        return d.get("base_step")

    def chain_steps(self, step: int, *, strict: bool = False) -> List[int]:
        """``[keyframe, ..., step]`` for a differential step (ascending);
        ``[step]`` for keyframes / full snapshots / manifest-less steps.
        Manifests come from any tier. Lenient mode (GC and audit callers)
        treats an unreadable ancestor or corrupt base metadata as the
        chain root; ``strict=True`` (restore) raises instead, so a broken
        chain is never replayed from mid-way."""
        chain = [step]
        seen = {step}
        cur = step
        while True:
            try:
                m = self.manifest_any_tier(cur)
            except (BackendError, OSError, ValueError):
                if strict and cur != step:
                    raise
                return list(reversed(chain))  # legacy/unreadable root
            d = (m.meta or {}).get("delta") or {}
            if d.get("keyframe", True):
                return list(reversed(chain))
            base = d.get("base_step")
            if base is None or base in seen:
                if strict:
                    raise BackendError(
                        f"step {step}: corrupt delta-chain metadata at "
                        f"step {cur} (base_step={base})")
                return list(reversed(chain))
            chain.append(base)
            seen.add(base)
            cur = base

    def chain_closure(self, steps: Iterable[int]) -> Set[int]:
        """``steps`` plus every chain ancestor down to each keyframe — the
        retention unit of differential checkpointing: a retained/pinned
        delta step keeps its whole chain."""
        out: Set[int] = set(steps)
        stack = list(out)
        while stack:
            base = self.delta_base(stack.pop())
            if base is not None and base not in out:
                out.add(base)
                stack.append(base)
        return out

    # ------------------------------------------------------------------ pins
    @property
    def _pins_path(self) -> str:
        return os.path.join(self.catalog_dir, "pins.json")

    def pins(self) -> Set[int]:
        try:
            with open(self._pins_path) as f:
                return set(json.load(f).get("pinned", []))
        except (OSError, ValueError):
            return set()

    def _write_pins(self, pinned: Set[int]) -> None:
        self._local.put(f"{CATALOG_DIR}/pins.json",
                        json.dumps({"pinned": sorted(pinned)}).encode())

    def pin(self, step: int) -> None:
        self._write_pins(self.pins() | {step})

    def unpin(self, step: int) -> None:
        self._write_pins(self.pins() - {step})

    # ---------------------------------------------------------------- verify
    def verify_step(self, step: int, *, check_checksums: bool = True
                    ) -> VerifyResult:
        """Re-audit a committed step's local files against its manifest,
        re-reading every byte and checksumming it on the device."""
        manifest = self.manifest(step)
        res = VerifyResult(step=step, ok=True)
        sdir = self.step_dir(step)
        for fe in manifest.files:
            path = os.path.join(sdir, fe.name)
            if not os.path.isfile(path):
                res.missing.append(fe.name)
                continue
            if os.path.getsize(path) != fe.nbytes:
                res.size_mismatch.append(fe.name)
                continue
            if check_checksums and fe.checksum is not None \
                    and file_checksum(path, self.device) != fe.checksum:
                res.checksum_mismatch.append(fe.name)
                for loc in self._locate_chunks(path):
                    res.chunk_mismatch.append(f"{fe.name}: {loc}")
        res.ok = not res.problems
        return res

    def _locate_chunks(self, path: str) -> List[str]:
        """Narrow a whole-file checksum mismatch to the damaged chunk(s)
        using the per-chunk digests in the container footer. Best-effort:
        a file too damaged to parse stays localized at file granularity."""
        if not path.endswith(".dsllm"):
            return []
        try:
            from repro_torch.core.layout import FileReader
            return FileReader(path).locate_corrupt_chunks(self.device)
        except Exception:  # noqa: BLE001 — footer itself may be damaged
            return []

    def _local_complete(self, step: int) -> bool:
        """Catalog entry present and every file on disk at manifest size."""
        if not self.has_manifest(step):
            return False
        try:
            manifest = self.manifest(step)
        except (BackendError, ValueError):
            return False
        sdir = self.step_dir(step)
        for fe in manifest.files:
            path = os.path.join(sdir, fe.name)
            if not os.path.isfile(path) \
                    or os.path.getsize(path) != fe.nbytes:
                return False
        return True

    # --------------------------------------------------------------- cascade
    def tier_has_step(self, tier: Tier, step: int) -> bool:
        """Complete-on-tier test: the manifest object is uploaded last, so
        its presence implies every data object landed."""
        return tier.backend.exists(catalog_key(step))

    def tier_steps(self, tier: Tier) -> List[int]:
        steps = []
        for key in tier.backend.list(f"{CATALOG_DIR}/step-"):
            m = _STEP_RE.search(key)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def cascade_step(self, step: int) -> None:
        """Replicate one committed step to every remote tier (synchronous;
        the background worker calls this off the training path)."""
        for tier in self.remote_tiers:
            self._cascade_step_to_tier(step, tier)

    def _cascade_step_to_tier(self, step: int, tier: Tier,
                              _depth: int = 0) -> None:
        """One step onto one tier — chains ship whole or not at all: a
        differential step's ancestors are uploaded first (recursively), so
        the tier never holds a delta whose keyframe it cannot produce."""
        if _depth > 4096:
            raise BackendError(
                f"step {step}: delta-chain recursion exceeded sanity bound")
        manifest = self.manifest(step)
        sdir = self.step_dir(step)
        payload = manifest.to_json_bytes()
        d = (manifest.meta or {}).get("delta") or {}
        base = None if d.get("keyframe", True) else d.get("base_step")
        if base is not None and not self.tier_has_step(tier, base):
            if not self._local_complete(base):
                raise BackendError(
                    f"step {step}: chain base {base} is neither on tier "
                    f"{tier.name!r} nor complete locally — shipping "
                    f"nothing (chains cascade whole or not at all)")
            self._cascade_step_to_tier(base, tier, _depth + 1)
        if self.tier_has_step(tier, step):
            # Identical manifest => identical bytes already landed. A
            # *different* manifest means the step was re-saved after an
            # earlier cascade (rewind): re-upload, or a later local GC
            # would re-hydrate the stale bytes.
            if tier.backend.get(catalog_key(step)) == payload:
                return
            tier.backend.delete(catalog_key(step))  # invisible first
        t0 = time.perf_counter()
        nbytes = 0
        uploaded: List[str] = []
        try:
            for fe in manifest.files:
                key = data_key(step, fe.name)
                nbytes += tier.backend.put_file(
                    key, os.path.join(sdir, fe.name))
                uploaded.append(key)
            # manifest last: the step is visible on the tier iff complete
            tier.backend.put(catalog_key(step), payload)
            # drop data objects a superseded upload left behind that the
            # new manifest no longer references
            expected = {data_key(step, fe.name) for fe in manifest.files}
            for key in tier.backend.list(f"{step_dirname(step)}/"):
                if key not in expected:
                    tier.backend.delete(key)
        except BaseException:
            # Never leak manifest-less data objects: tier GC only
            # enumerates cataloged steps, so stragglers would be
            # undeletable (and could wedge a capacity-bound tier).
            for key in uploaded:
                try:
                    tier.backend.delete(key)
                except (BackendError, OSError):
                    pass
            raise
        t1 = time.perf_counter()
        with self._lock:
            self.cascade_log.append(CascadeEvent(
                step=step, tier=tier.name, nbytes=nbytes,
                t_start=t0, t_end=t1))
        obs_metrics.inc("repo.cascade_bytes", nbytes)
        obs.add_span("cascade.upload", t0, t1, step=step, tier=tier.name,
                     bytes=nbytes, flow=obs.flow_id("save", step))

    def _cascade_worker(self) -> None:
        q = self._cascade_q
        while True:
            step = q.get()
            if step is None:
                q.task_done()
                return
            try:
                self.cascade_step(step)
            except Exception as exc:  # noqa: BLE001 — recorded, lane lives
                with self._lock:
                    self.cascade_errors.append((step, repr(exc)))
            finally:
                with self._lock:
                    self._mid_cascade.discard(step)
                q.task_done()

    def wait_cascaded(self) -> None:
        if self._cascade_q is not None:
            self._cascade_q.join()

    # -------------------------------------------------------------- restore
    def attach_fleet(self, fabric: Optional[Any]) -> None:
        """Route this repository's remote re-hydration through a fleet
        distribution fabric (:class:`repro_torch.fleet.FleetFabric`). The
        fabric's cache/peer-exchange path replaces direct tier reads on
        restore resolution; any fabric failure degrades back to direct
        tier fetches. Pass ``None`` to detach."""
        self._fleet = fabric

    def resolve_for_restore(self, step: int) -> str:
        """Local directory for ``step``, re-hydrating tier-by-tier.

        Preference order: complete local copy → the attached fleet fabric
        → fetch from the first remote tier holding a complete copy
        (verified against the manifest, staged, then atomically renamed
        into place) → whatever partial local directory exists (the
        restore engine produces the precise failure)."""
        sdir = self.step_dir(step)
        if self._local_complete(step):
            return sdir
        fetch_exc: Optional[BaseException] = None
        if self._fleet is not None:
            try:
                got = self._fleet.fetch_step(self, step)
                if got is not None:
                    return got
            except (BackendError, OSError, ValueError) as exc:
                fetch_exc = exc  # degrade to direct tier reads below
        for tier in self.remote_tiers:
            try:
                if not self.tier_has_step(tier, step):
                    continue
                return self._fetch_from_tier(tier, step)
            except (BackendError, OSError, ValueError) as exc:
                # this tier's copy is damaged or unreachable — a lower
                # tier may still hold a good one
                fetch_exc = exc
                continue
        if os.path.isdir(sdir):
            return sdir
        if fetch_exc is not None:
            raise BackendError(
                f"step {step}: every tier holding a copy failed to "
                f"produce a verified one") from fetch_exc
        raise FileNotFoundError(
            f"step {step} not present on any tier of {self.root}")

    def _fetch_from_tier(self, tier: Tier, step: int) -> str:
        manifest = StepManifest.from_json_bytes(
            tier.backend.get(catalog_key(step)))
        staging = self.new_staging_dir(step)
        try:
            for fe in manifest.files:
                tier.backend.get_file(data_key(step, fe.name),
                                      os.path.join(staging, fe.name))
            return self.admit_fetched_step(step, manifest, staging,
                                           source=f"tier {tier.name!r}")
        except BaseException:
            shutil.rmtree(staging, ignore_errors=True)
            raise

    def new_staging_dir(self, step: int) -> str:
        """Private staging directory for a step being re-hydrated (one per
        fetch attempt; the caller owns cleanup on failure)."""
        staging = os.path.join(self.catalog_dir, "staging",
                               f"step-{step}-{uuid.uuid4().hex[:8]}")
        os.makedirs(staging, exist_ok=True)
        return staging

    def admit_fetched_step(self, step: int, manifest: StepManifest,
                           staging: str, *, source: str = "fetch") -> str:
        """Verify a fully-staged fetch against its manifest — every file's
        size, and its checksum on ``self.device`` — and publish it
        atomically. The single sanctioned re-hydration publish: direct
        tier fetches and the fleet fabric both funnel through here, so
        unverified bytes can never become a visible local step. Raises
        (leaving ``staging`` for the caller to clean up) on any size or
        checksum mismatch."""
        with lane_stream(self.device):
            for fe in manifest.files:
                dst = os.path.join(staging, fe.name)
                if not os.path.isfile(dst):
                    raise BackendError(
                        f"{source} staged step {step} without {fe.name}")
                if os.path.getsize(dst) != fe.nbytes:
                    raise BackendError(
                        f"{source} returned {fe.name} with "
                        f"{os.path.getsize(dst)} B, manifest says "
                        f"{fe.nbytes} B")
                if fe.checksum is not None \
                        and file_checksum(dst, self.device) != fe.checksum:
                    raise BackendError(
                        f"{source} returned {fe.name} with a checksum "
                        f"mismatch (bitrot in remote storage?)")
        sdir = self.step_dir(step)
        # every file was size- and checksum-verified into a private
        # staging dir; the one-shot directory rename is the atomic publish
        # (the manifest re-admission below still happens last)
        publish_dir(staging, sdir)
        # re-admit to the local catalog so the next resolve is a local hit
        self._local.put(catalog_key(step), manifest.to_json_bytes())
        with self._lock:
            self._manifest_cache[step] = manifest
        return sdir

    # -------------------------------------------------------------------- gc
    def local_footprint_bytes(self) -> int:
        return sum(_dir_size(d) for d in step_dirs(self.root).values())

    @contextlib.contextmanager
    def reading(self, step: int):
        """Protect ``step`` from GC while a restore reads its files (the
        committer's auto-GC runs concurrently with restores)."""
        with self._lock:
            self._reading[step] = self._reading.get(step, 0) + 1
        try:
            yield
        finally:
            with self._lock:
                n = self._reading.get(step, 0) - 1
                if n <= 0:
                    self._reading.pop(step, None)
                else:
                    self._reading[step] = n

    def _protected(self, steps: Sequence[int]) -> Set[int]:
        with self._lock:
            protected = set(self._active) | set(self._mid_cascade) \
                | set(self._reading)
        protected |= self.pins()
        if steps:
            protected.add(max(steps))  # never delete the newest complete
        return protected

    def _orphan_age_s(self, step: int) -> float:
        """Seconds since the orphan's save started (marker timestamp, or
        the directory mtime for marker-less probe failures), clamped to
        >= 0: a wall clock stepped backwards reads as "this save just
        started", inside any grace window."""
        try:
            with open(self._marker_path(step)) as f:
                age = time.time() - float(f.read().strip())
        except (OSError, ValueError):
            try:
                age = time.time() - os.path.getmtime(self.step_dir(step))
            except OSError:
                return float("inf")
        if age < 0:
            logger.warning(
                "orphan step %d has a future-dated marker/mtime (%.3fs "
                "ahead): wall clock stepped backwards; treating the "
                "orphan as fresh (age 0)", step, -age)
            return 0.0
        return age

    def gc(self, *, include_orphans: bool = False, dry_run: bool = False,
           retention: Optional[RetentionPolicy] = None,
           orphan_grace_s: float = 0.0) -> GCReport:
        """Apply retention. Never touches the newest complete step, pinned
        steps, active saves, steps still cascading or being read, or a
        chain ancestor of anything kept.

        In-flight protection is process-local (``_active``); an admin
        process (the CLI) cannot see a live training job's active save,
        which looks exactly like a crash orphan. ``orphan_grace_s`` covers
        that: orphans younger than the grace window are left alone."""
        t0 = time.perf_counter()
        report = GCReport(dry_run=dry_run)
        steps = self.local_steps()
        protected = self._protected(self.steps())
        policy = retention or self.retention
        retained = policy.retained(steps) if policy else set(steps)
        # chain-aware: a kept delta step keeps its keyframe and every
        # intermediate delta
        retained = self.chain_closure(retained | (protected & set(steps)))
        for step in steps:
            if step in retained or step in protected:
                continue
            report.deleted_steps.append(step)
            report.bytes_freed += _dir_size(self.step_dir(step))
            if not dry_run:
                self._delete_local_step(step)
        if include_orphans:
            for step in self.orphans():
                if step in protected:
                    continue
                if orphan_grace_s and \
                        self._orphan_age_s(step) < orphan_grace_s:
                    continue
                report.deleted_orphans.append(step)
                report.bytes_freed += _dir_size(self.step_dir(step))
                if not dry_run:
                    self._delete_local_step(step)
        for tier in self.remote_tiers:
            if tier.retention is None:
                continue
            tsteps = self.tier_steps(tier)
            keep = self.chain_closure(
                tier.retention.retained(tsteps)
                | (self._protected(tsteps) & set(tsteps)))
            doomed = [s for s in tsteps if s not in keep]
            if doomed:
                report.remote_deleted[tier.name] = doomed
            if not dry_run:
                for s in doomed:
                    self._delete_tier_step(tier, s)
        t1 = time.perf_counter()
        report.seconds = t1 - t0
        if not dry_run:
            with self._lock:
                self.gc_log.append(report)
            obs_metrics.inc("repo.gc_bytes_freed", report.bytes_freed)
            obs.add_span("gc", t0, t1, bytes_freed=report.bytes_freed,
                         steps=len(report.deleted_steps))
        return report

    def _delete_local_step(self, step: int) -> None:
        # catalog entry first: the step disappears from the catalog before
        # its data does, so a crash mid-GC leaves an orphan, never a
        # committed step with missing files.
        for path in (self._entry_path(step), self._marker_path(step)):
            try:
                os.unlink(path)
            except FileNotFoundError:
                pass
        with self._lock:
            self._manifest_cache.pop(step, None)
        shutil.rmtree(self.step_dir(step), ignore_errors=True)

    def _delete_tier_step(self, tier: Tier, step: int) -> None:
        tier.backend.delete(catalog_key(step))  # invisible first
        for key in tier.backend.list(f"{step_dirname(step)}/"):
            tier.backend.delete(key)

    # ------------------------------------------------------------------ misc
    def drain(self) -> None:
        """Wait until every queued cascade has finished (or failed)."""
        self.wait_cascaded()

    def close(self) -> None:
        """Finish the queued cascades and join the cascade thread."""
        if self._cascade_q is not None:
            self._cascade_q.put(None)
            if self._cascade_thread is not None:
                self._cascade_thread.join()
            self._cascade_q = None
            self._cascade_thread = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
