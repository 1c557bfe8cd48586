"""Catalog-backed checkpoint repository, local tier.

The repository owns the **catalog**: one atomically-written manifest per
committed step under ``<root>/.catalog/``. A step is visible iff its
manifest exists; an in-flight marker (written before any data file)
distinguishes crash victims from legacy pre-repository directories, so
``latest_step`` can never select a half-written checkpoint. Directory,
catalog and marker names are the JAX package's, so either package reads
the other's repository.

Not yet ported from ``repro/storage/repository.py``: the cascade flusher
to remote tiers, retention GC, pins and the fleet fabric.
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import os
import re
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import torch

from repro_torch.analysis.locks import declares_lock
from repro_torch.obs import trace as obs

from .backend import BackendError, LocalBackend
from .manifest import StepManifest, file_checksum, probe_step_complete

CATALOG_DIR = ".catalog"
_STEP_RE = re.compile(r"step-(\d+)\.json$")
_MARKER_RE = re.compile(r"inflight-(\d+)$")


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


@declares_lock("repository.state", rank=40, attrs=("_lock",))
class CheckpointRepository:
    """Catalog-backed home for checkpoint steps on the local tier.

    ``device`` is where verify computes file checksums (the checksum
    kernel on a card)."""

    def __init__(self, root: str, *, device: torch.device,
                 checksum: bool = True):
        self.root = os.path.abspath(root)
        self.device = torch.device(device)
        self.checksum = checksum
        self.catalog_dir = os.path.join(self.root, CATALOG_DIR)
        os.makedirs(self.catalog_dir, exist_ok=True)
        self._local = LocalBackend(self.root)
        self._lock = threading.Lock()  # declared: repository.state (r40)
        self._active: Set[int] = set()        # begun in this process
        self._reading: Dict[int, int] = {}    # restore refcounts
        self._manifest_cache: Dict[int, StepManifest] = {}

    # ------------------------------------------------------------- locations
    def step_dir(self, step: int) -> str:
        return os.path.join(self.root, step_dirname(step))

    def _entry_path(self, step: int) -> str:
        return os.path.join(self.catalog_dir, entry_name(step))

    def _marker_path(self, step: int) -> str:
        return os.path.join(self.catalog_dir, marker_name(step))

    # ------------------------------------------------------------- lifecycle
    def begin_step(self, step: int) -> str:
        """Declare a save in flight: marker first, so a crash at any later
        point leaves an identifiable orphan. Re-saving a committed step
        retracts its catalog entry, retracts every committed delta step
        whose chain passes through it, and clears the old data files."""
        with self._lock:
            self._active.add(step)
            self._manifest_cache.pop(step, None)
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
        invisible orphans (catalog entry -> in-flight marker): they were
        XOR-encoded against the bytes about to be replaced. Chains only
        point backwards, so forward progress scans nothing."""
        for s in [s for s in self.steps() if s > step]:
            try:
                dependent = step in self.chain_steps(s, strict=True)
            except (BackendError, OSError, ValueError):
                dependent = True  # cannot prove independence: retract
            if not dependent:
                continue
            try:
                os.unlink(self._entry_path(s))
            except FileNotFoundError:
                pass
            self._local.put(marker_key(s), str(time.time()).encode("ascii"))
            with self._lock:
                self._manifest_cache.pop(s, None)

    def abort_step(self, step: int) -> None:
        """A save failed after ``begin_step``: the marker stays (the step
        is an orphan), but it is no longer an *active* save."""
        with self._lock:
            self._active.discard(step)

    def commit_step(self, step: int, *, engine_mode: Optional[str] = None,
                    meta: Optional[Dict[str, Any]] = None,
                    expect_ranks: Optional[int] = None,
                    writers: Optional[Sequence[int]] = None,
                    nodes: Optional[Dict[int, Any]] = None) -> StepManifest:
        """Make a fully-persisted step visible: build its manifest (sizes +
        checksums) and write it atomically *last*.

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
        return manifest

    # --------------------------------------------------------------- catalog
    def steps(self) -> List[int]:
        return committed_steps(self.root)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

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

    # ----------------------------------------------------------- delta chains
    def chain_steps(self, step: int, *, strict: bool = False) -> List[int]:
        """``[keyframe, ..., step]`` for a differential step (ascending);
        ``[step]`` for keyframes / full snapshots / manifest-less steps.
        ``strict=True`` (restore) raises on an unreadable ancestor or
        corrupt base metadata instead of returning a shorter chain."""
        chain = [step]
        seen = {step}
        cur = step
        while True:
            try:
                m = self.manifest(cur)
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

    # ---------------------------------------------------------------- verify
    def verify_step(self, step: int, *, check_checksums: bool = True
                    ) -> VerifyResult:
        """Re-audit a committed step's files against its manifest,
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

    # -------------------------------------------------------------- restore
    def resolve_for_restore(self, step: int) -> str:
        """Local directory for ``step``: the complete local copy, else
        whatever partial directory exists (the restore engine produces the
        precise failure). Re-hydration from remote tiers is not yet
        ported."""
        sdir = self.step_dir(step)
        if self._local_complete(step) or os.path.isdir(sdir):
            return sdir
        raise FileNotFoundError(f"step {step} not present in {self.root}")

    @contextlib.contextmanager
    def reading(self, step: int):
        """Mark ``step`` as being read by a restore (the guard retention GC
        honours once it is ported)."""
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

    def drain(self) -> None:
        """Nothing runs in the background on the local tier."""

    def close(self) -> None:
        """Nothing to release on the local tier."""
