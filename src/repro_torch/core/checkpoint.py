"""Checkpoint manager: lazy non-blocking capture + consistent restore.

The manager is the training-runtime-facing API (paper §V-B). It is built
from a declarative :class:`~repro_torch.core.policy.CheckpointPolicy` and
an explicit ``device`` (``CheckpointManager.from_policy(directory, policy,
device="cuda")``), owns the DataStates engine, plans the shard composition
— routing each leaf of the named state domains through the policy's
:class:`~repro_torch.core.registry.StateProviderRegistry` — and exposes the
two consistency points of the lazy protocol (paper §V-A2, Fig 6(c,d)):

* ``save(step, state)`` — returns right after the blocking prologue
  (planning + coalesced reservation + launch of the chunked
  device-to-host copies on a side stream);
* ``wait_for_capture()`` — the barrier the training loop calls **before
  the in-place optimizer update** of the following iteration: PyTorch's
  ``optimizer.step()`` overwrites the very buffers being copied, so it may
  only run once every copy event has completed.

Persisted steps live in a :class:`~repro_torch.storage.CheckpointRepository`:
once the engine reports a step fully persisted, a background committer
writes the step's catalog manifest (file list, sizes, checksums)
atomically *last* — so ``latest_step()`` only ever sees complete steps —
queues the step's cascade to the policy's remote ``tiers``, and applies
its ``retention``. A restore resolves every chain member tier by tier
(re-hydrating a step the local tier lacks), and ``step=None`` takes the
newest step on any tier. ``close()`` drains the cascade.

``device`` is where the checkpoint kernels run (delta encode, chain fold,
checksums) and is passed down to the engine, the codecs, the
:class:`~repro_torch.core.restore.RestoreEngine` and the repository's
verify. ``device="cuda"`` on a host without a card raises: nothing falls
back to the CPU unless the caller asks for it.

``EnginePolicy.mode`` picks one of the four engines the paper compares
(:data:`ENGINES`: ``sync``, ``snapshot``, ``datastates-old``,
``datastates``); a restore reads the steps of any of them.

``DistPolicy.world = N`` (or an explicit coordinator) saves through N
writer ranks of a :class:`~repro_torch.dist.Coordinator`, threads or
spawned processes, under the hierarchical two-phase commit; a step becomes
visible only once every rank and node voted. Restore is elastic: an
N-rank step restores onto any mesh and any world (plain tensors or
:class:`~repro_torch.sharding.ShardedTensor` templates).

``DistPolicy(group=True)`` runs one manager on each rank of a
``torch.distributed`` group, over ``DTensor`` state: rank *r* writes its
own shards (the ones the planner's writer rule gives it) to
``rank{r:05d}.dsllm`` and casts its vote; the votes meet in an
``all_gather`` on a gloo group of the manager's own (its committer thread
must not share the training's group); rank 0 writes the step's manifest
last, after every rank's file and vote, and every rank learns the
outcome. The step is the format every other save writes, so either
package restores it. A restore into ``DTensor`` templates reads each
rank's own region.

The JAX package's deprecated flat-kwarg constructor
(``CheckpointManager(directory, mode=..., tiers=..., device="cpu")``) is
kept: each kwarg maps onto one policy field
(:data:`~repro_torch.core.policy.LEGACY_KWARG_MAP`) and warns with a
``DeprecationWarning``; compose a policy instead.
"""

from __future__ import annotations

import contextlib
import os
import queue
import threading
import time
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.analysis.locks import declares_lock
from repro_torch.kernels.ops import lane_stream
from repro_torch.obs import trace as obs
from repro_torch.obs.metrics import metrics as obs_metrics
from repro_torch.storage.backend import BackendError
from repro_torch.storage.repository import (CheckpointRepository,
                                            RetentionPolicy, Tier,
                                            committed_steps)

from .baselines import (BaseCheckpointEngine, DataStatesEngine,
                        DataStatesOldEngine, SnapshotThenFlushEngine,
                        SyncSerializedEngine)
from .distributed import group_by_rank, plan_shards
from .engine import CheckpointError, CheckpointFuture
from .policy import CheckpointPolicy, DeltaPolicy
from .restore import RestoreEngine, RestoreError, RestoreStats
from .state_provider import DeltaSaveSpec


_UNSET: Any = object()

ENGINES = {
    "datastates": DataStatesEngine,          # this paper
    "datastates-old": DataStatesOldEngine,   # HPDC'24 prior work
    "snapshot": SnapshotThenFlushEngine,     # TorchSnapshot-style
    "sync": SyncSerializedEngine,            # DeepSpeed default (torch.save)
}


def resolve_device(device) -> torch.device:
    """The device the checkpoint kernels run on. A CUDA device on a host
    without a usable card raises instead of quietly running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was requested but torch.cuda."
            f"is_available() is False on this host (no CUDA card or a "
            f"CPU-only PyTorch); pass device='cpu' to run the checkpoint "
            f"kernels' plain versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported checkpoint device {dev}")
    return dev


@declares_lock("manager.delta_tracker", rank=30, attrs=("_lock",))
class _DeltaChainTracker:
    """Decides keyframe vs delta per save and tracks the chain position.

    The fingerprint (shard names + dtypes + sizes) detects elastic
    reshards; any engine/commit failure invalidates the tracker so the
    next save re-arms the chain with a keyframe.
    """

    def __init__(self, policy: DeltaPolicy):
        self.policy = policy
        self._lock = threading.Lock()
        self._fingerprint: Optional[tuple] = None
        self._last_step: Optional[int] = None
        self._n_since_keyframe = 0

    def plan(self, step: int, records) -> DeltaSaveSpec:
        fp = tuple(sorted((r.tensor_name, r.dtype, int(r.nbytes))
                          for r in records))
        with self._lock:
            if self._last_step is not None and step <= self._last_step:
                # rewind-resave: chaining onto a *later* step would record
                # base_step > step (a cycle); re-arm with a keyframe
                self._fingerprint = None
                self._last_step = None
            keyframe = (
                self._fingerprint != fp
                or self._last_step is None
                or self._n_since_keyframe >= self.policy.keyframe_every - 1)
            if keyframe:
                spec = DeltaSaveSpec(step=step, keyframe=True,
                                     codec=self.policy.codec)
                self._n_since_keyframe = 0
            else:
                spec = DeltaSaveSpec(
                    step=step, keyframe=False, base_step=self._last_step,
                    chain_depth=self._n_since_keyframe + 1,
                    codec=self.policy.codec)
                self._n_since_keyframe += 1
            self._fingerprint = fp
            self._last_step = step
        return spec

    def invalidate(self) -> None:
        """A save failed (engine error or commit abort): the snapshot
        cache / on-disk chain can no longer be trusted as a base."""
        with self._lock:
            self._fingerprint = None
            self._last_step = None
            self._n_since_keyframe = 0


def step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"global_step{step}")


def latest_step(directory: str) -> Optional[int]:
    """Highest *complete* step, or None.

    Complete = committed to the repository catalog (manifest present), or
    a legacy pre-repository directory that passes the per-format
    completeness probe. A directory left by a crashed save — data files
    but no manifest — is never eligible, so resume cannot select a
    half-written checkpoint (the seed picked any ``global_step*`` dir).
    """
    steps = committed_steps(directory)
    return steps[-1] if steps else None


# ---------------------------------------------------------------------------
# Shared catalog-driven restore path: selective (per-domain) restore,
# delta-chain replay and damaged-step skipping live here once.

def _subset_template(template: Any, domains: Optional[Sequence[str]]) -> Any:
    """Restrict ``template`` to the requested state domains."""
    if domains is None:
        return template
    if not isinstance(template, dict):
        raise ValueError(
            "restore(domains=...) needs the template to be a mapping of "
            "named state domains at its top level "
            "({'model': ..., 'optimizer': ..., ...})")
    missing = [d for d in domains if d not in template]
    if missing:
        raise KeyError(
            f"requested domains {missing} not in template "
            f"(have {sorted(template)})")
    return {d: template[d] for d in domains}


def _chain_for(repository: CheckpointRepository, step: int) -> List[int]:
    """[keyframe, ..., step] for a differential step (ascending), or
    ``[step]`` for a full snapshot / legacy manifest-less step. Strict
    walk: an unreadable ancestor or corrupt base metadata is a broken
    chain, never a shorter one."""
    try:
        return repository.chain_steps(step, strict=True)
    except (BackendError, OSError, ValueError) as exc:
        raise RestoreError(
            f"step {step}: delta chain unreadable — {exc}") from exc


def _verify_chain(repository: CheckpointRepository,
                  chain: Sequence[int]) -> None:
    """Every member of a delta chain must be checksum-clean before
    replay: XOR folding silently amplifies a corrupt keyframe or
    intermediate delta into every downstream tensor."""
    for c in chain:
        if not repository.has_manifest(c):
            continue  # re-hydrated legacy copy: nothing to audit against
        res = repository.verify_step(c)
        if not res.ok:
            raise RestoreError(
                f"delta-chain member step {c} failed verification "
                f"({', '.join(res.problems)}) — refusing chain replay")


def restore_from_repository(
        repository: CheckpointRepository, template: Any, *,
        step: Optional[int] = None,
        engine: Optional[RestoreEngine] = None,
        fallback: Optional[bool] = None,
        domains: Optional[Sequence[str]] = None,
        verify_chain: bool = True) -> Tuple[Any, RestoreStats, int]:
    """Rebuild ``template``-shaped state from a repository's catalog.

    ``domains`` restricts the restore to the named state domains (top-level
    keys of the template mapping): only those sub-trees are planned, so
    only their byte ranges are read — the bytes-minimal selective restore
    of arXiv 2512.24511 — and the returned tree keeps the template's own
    values for every unrequested domain.

    Step selection and delta-chain replay follow
    :meth:`CheckpointManager.restore` semantics exactly (this *is* that
    path): ``step=None`` walks committed steps on every tier newest→oldest
    past damaged ones, an explicit step surfaces its own error, and a chain
    member missing from the local tier is re-hydrated from the first
    remote tier holding a verified copy. A delta step's whole chain is
    re-verified against its manifest checksums (on the repository's
    device) before the XOR fold. Returns ``(tree, stats,
    restored_step)``.
    """
    sub_template = _subset_template(template, domains)
    if step is None:
        candidates = list(reversed(repository.steps()))
        if not candidates:
            raise FileNotFoundError(f"no checkpoints in {repository.root}")
        if fallback is None:
            fallback = True
    else:
        candidates = [step]
        if fallback is None:
            fallback = False
    eng = engine or RestoreEngine(repository.device)
    last_exc: Optional[BaseException] = None
    for s in candidates:
        try:
            chain = _chain_for(repository, s)
            with contextlib.ExitStack() as stack:
                for c in chain:  # shield the whole chain from auto-GC
                    stack.enter_context(repository.reading(c))
                sdirs = [repository.resolve_for_restore(c) for c in chain]
                t_v = time.perf_counter()
                if len(chain) > 1 and verify_chain:
                    with lane_stream(repository.device):
                        _verify_chain(repository, chain)
                verify_s = time.perf_counter() - t_v
                if len(chain) == 1:
                    tree, stats = eng.restore(sdirs[0], sub_template)
                else:
                    tree, stats = eng.restore_chain(sdirs, sub_template)
                stats.verify_s = verify_s
        except (RestoreError, FileNotFoundError, KeyError, OSError,
                BackendError, ValueError) as exc:
            if not fallback:
                raise
            last_exc = exc
            continue
        if domains is not None:
            merged = dict(template)
            merged.update(tree)
            tree = merged
        return tree, stats, s
    raise RestoreError(
        f"no restorable checkpoint among steps {candidates} in "
        f"{repository.root}") from last_exc


class CheckpointManager:
    """Checkpoint manager (one writer, or N ranks through a coordinator);
    build it with :meth:`from_policy`."""

    def __init__(self, directory: str, mode: str = _UNSET,
                 host_cache_bytes: int = _UNSET,
                 flush_threads: int = _UNSET,
                 chunk_bytes: int = _UNSET,
                 throttle_mbps: Optional[float] = _UNSET,
                 restore_threads: Optional[int] = _UNSET,
                 tiers: Sequence[Tier] = _UNSET,
                 retention: Optional[RetentionPolicy] = _UNSET,
                 manifest_checksums: bool = _UNSET,
                 world: Optional[int] = _UNSET,
                 coordinator: Optional[Any] = _UNSET,
                 ack_timeout_s: Optional[float] = _UNSET,
                 delta: Optional[DeltaPolicy] = _UNSET,
                 *, policy: Optional[CheckpointPolicy] = None,
                 device: torch.device = "cuda"):
        """Construct a manager on ``device`` (the card unless the caller
        asks for ``"cpu"``).

        .. deprecated::
            The flat-kwarg surface (``mode=``, ``tiers=``, ``world=``,
            ``delta=``, ...) is deprecated: every kwarg maps onto exactly
            one field of a :class:`~repro_torch.core.policy.CheckpointPolicy`
            (``LEGACY_KWARG_MAP``). Compose a policy and call
            :meth:`from_policy` instead; legacy kwargs keep working through
            :meth:`CheckpointPolicy.from_legacy_kwargs` but emit a
            ``DeprecationWarning``.
        """
        legacy = {k: v for k, v in dict(
            mode=mode, host_cache_bytes=host_cache_bytes,
            flush_threads=flush_threads, chunk_bytes=chunk_bytes,
            throttle_mbps=throttle_mbps, restore_threads=restore_threads,
            tiers=tiers, retention=retention,
            manifest_checksums=manifest_checksums, world=world,
            coordinator=coordinator, ack_timeout_s=ack_timeout_s,
            delta=delta).items() if v is not _UNSET}
        if policy is not None and legacy:
            raise ValueError(
                f"pass either policy= or legacy constructor kwargs, not "
                f"both (got {sorted(legacy)} alongside a policy)")
        if policy is None:
            if legacy:
                warnings.warn(
                    "CheckpointManager(directory, mode=..., tiers=..., "
                    "world=..., delta=..., ...) flat kwargs are "
                    "deprecated; compose a CheckpointPolicy and use "
                    "CheckpointManager.from_policy(directory, policy, "
                    "device=...) — see the README migration table",
                    DeprecationWarning, stacklevel=2)
            policy = CheckpointPolicy.from_legacy_kwargs(**legacy)
        ep, sp, dp = policy.engine, policy.storage, policy.dist
        self.device = resolve_device(device)
        if ep.mode not in ENGINES:
            raise ValueError(f"unknown engine mode {ep.mode!r}; "
                             f"choose from {sorted(ENGINES)}")
        delta = policy.delta
        if delta is not None and ep.mode not in ("datastates",
                                                 "datastates-old"):
            raise ValueError(
                f"differential checkpointing requires a DataMovementEngine "
                f"mode (datastates / datastates-old), got {ep.mode!r}")
        self.policy = policy
        self.registry = policy.providers
        self.delta_policy = delta
        self._delta_tracker = _DeltaChainTracker(delta) \
            if delta is not None else None
        # last save's surviving writer set (multi-rank): a change means
        # shard slices moved between rank engines, so every per-rank
        # delta base is stale and the next save must keyframe
        self._last_writers: Optional[tuple] = None
        self.directory = directory
        self.mode = ep.mode
        os.makedirs(directory, exist_ok=True)
        self.repository = CheckpointRepository(
            directory, remote_tiers=sp.tiers, device=self.device,
            retention=sp.retention, checksum=sp.manifest_checksums)
        coordinator = dp.coordinator
        self._group = None
        if dp.group:
            import torch.distributed as dist
            if delta is not None:
                raise ValueError("group=True saves take no delta policy")
            # the votes' group: the committer thread's collectives must
            # not interleave with the training thread's on its group
            self._group = dist.new_group(backend="gloo")
            self._group_rank = dist.get_rank()
            self._group_world = dist.get_world_size()
        if coordinator is None and dp.world is not None and dp.world > 1:
            from repro_torch.dist.coordinator import Coordinator

            # ``world=N`` (N > 1) switches saves onto the multi-rank path:
            # N writer ranks, each with its own engine + host-cache lane,
            # drain a balanced partition of the shards concurrently; the
            # step becomes visible only after every rank acks and the
            # global manifest commits. host_cache_bytes and flush_threads
            # stay *node totals*: divided across the ranks, so world=N
            # neither multiplies the pinned budget nor loosens
            # back-pressure (a coordinator built by hand takes per-rank
            # values instead).
            coordinator = Coordinator(
                dp.world, device=self.device, mode=ep.mode,
                runtime=dp.runtime, node_size=dp.node_size,
                host_cache_bytes=max(1, ep.host_cache_bytes // dp.world),
                flush_threads=max(1, ep.flush_threads // dp.world),
                chunk_bytes=ep.chunk_bytes,
                throttle_mbps=ep.throttle_mbps,
                checksum_files=sp.manifest_checksums,
                ack_timeout_s=dp.ack_timeout_s)
        if coordinator is not None:
            if dp.world is not None and coordinator.world != dp.world:
                raise ValueError(
                    f"world={dp.world} does not match the provided "
                    f"coordinator's world={coordinator.world}")
            if coordinator.device != self.device:
                raise ValueError(
                    f"the coordinator runs on {coordinator.device}, the "
                    f"manager on {self.device}")
        self.coordinator = coordinator
        # Multi-rank managers save through the coordinator's per-rank
        # engines; a single-writer engine too would pin a host cache and
        # idle flush threads for a lane that never runs.
        self.engine: Optional[BaseCheckpointEngine] = None
        if coordinator is None:
            self.engine = ENGINES[ep.mode](
                device=self.device,
                host_cache_bytes=ep.host_cache_bytes,
                flush_threads=ep.flush_threads,
                chunk_bytes=ep.chunk_bytes,
                throttle_mbps=ep.throttle_mbps,
                checksum_files=sp.manifest_checksums)
        self.restore_engine = RestoreEngine(self.device,
                                            threads=ep.restore_threads)
        self.last_restore_stats: Optional[RestoreStats] = None
        self.last_restored_step: Optional[int] = None
        self._inflight: List[CheckpointFuture] = []
        # Committer lane: waits for engine persist, then commits the step's
        # manifest to the catalog (and kicks cascade + retention GC) off
        # the training path.
        self._commit_q: "queue.Queue[Optional[CheckpointFuture]]" = \
            queue.Queue()
        self._commit_events: Dict[int, threading.Event] = {}
        self.commit_errors: List[tuple] = []
        self._committer = threading.Thread(
            target=self._commit_lane, daemon=True, name="ckpt-commit")
        self._committer.start()

    @classmethod
    def from_policy(cls, directory: str,
                    policy: Optional[CheckpointPolicy] = None,
                    device: torch.device = "cuda") -> "CheckpointManager":
        """The policy-first constructor: one composable
        :class:`~repro_torch.core.policy.CheckpointPolicy` (``None`` means
        all defaults) and the device the checkpoint kernels run on — the
        card unless the caller asks for ``"cpu"``."""
        return cls(directory, policy=policy or CheckpointPolicy(),
                   device=device)

    # ------------------------------------------------------------------ save
    def save(self, step: int, state: Any, blocking: bool = False
             ) -> CheckpointFuture:
        """Request a checkpoint of ``state`` (any pytree of torch tensors,
        numpy arrays and Python objects). Returns after the engine's
        blocking prologue only."""
        future = CheckpointFuture(step, step_dir(self.directory, step))
        t0 = time.perf_counter()
        future.stats.t_request = t0
        obs.instant("save.request", step=step,
                    flow=obs.flow_id("save", step), flow_phase="start")
        # A previous save of this very step still in flight would have its
        # directory rmtree'd under its flush threads by begin_step, and
        # its committer could then manifest our half-written files. Settle
        # it first (no-op unless the caller re-saves the same step).
        self.wait_for_commit(step)
        records, objects = plan_shards(state, group="state",
                                       registry=self.registry)
        world = self.coordinator.world if self.coordinator is not None \
            else self._group_world if self._group is not None else 1
        objects["__checkpoint_meta__"] = {"step": step, "mode": self.mode,
                                          "n_shards": len(records),
                                          "world": world}
        delta_spec = None
        if self._delta_tracker is not None:
            if self.coordinator is not None:
                # a rank death reassigns its shard slice to survivors
                # whose engines hold no snapshot of it: force a keyframe
                # whenever the writer set changed since the last save
                writers_now = self.coordinator.active_writers()
                if self._last_writers is not None \
                        and writers_now != self._last_writers:
                    self._delta_tracker.invalidate()
                self._last_writers = writers_now
            delta_spec = self._delta_tracker.plan(step, records)
            future.stats.extra["delta"] = delta_spec.manifest_meta()
        # (the engines fill stats.extra["domains"] — the step-level
        # domain→provider/codec summary — from their live provider
        # instances, so it can never drift from the per-file footers)
        # in-flight marker first: a crash at any later point leaves an
        # identifiable orphan, never a resume-eligible directory.
        if self._group is None or self._group_rank == 0:
            self.repository.begin_step(step)
        if self._group is not None:
            # no rank writes before rank 0 has cleared the step's
            # directory; on the caller's group (the votes' group belongs
            # to the committer thread)
            torch.distributed.barrier()
        os.makedirs(future.directory, exist_ok=True)
        try:
            if self._group is not None:
                # this rank's records (the planner's writer rule) in its
                # own file, the object log in rank 0's
                me = self._group_rank
                future.stats.extra["world"] = world
                self.engine.save(future.directory,
                                 {me: [r for r in records if r.rank == me]},
                                 objects if me == 0 else {}, future)
            elif self.coordinator is not None:
                future.stats.extra["world"] = world
                # the commit topology of *this* save (surviving writers +
                # node membership) rides the future so phase 2 validates
                # exactly the votes the save was built to cast
                info = self.coordinator.submit(step, future.directory,
                                               records, objects, future,
                                               delta=delta_spec)
                future.stats.extra["writers"] = info["writers"]
                future.stats.extra["nodes"] = info["nodes"]
            else:
                by_rank = group_by_rank(records)
                self.engine.save(future.directory, by_rank, objects,
                                 future, delta=delta_spec)
        except BaseException:
            # A synchronous prologue failure (e.g. payload exceeds the
            # host cache) never reaches the committer: retract the active
            # claim so in-process GC can reclaim the orphaned directory.
            self.repository.abort_step(step)
            if self._delta_tracker is not None:
                self._delta_tracker.invalidate()
            raise
        future.stats.blocking_s = time.perf_counter() - t0
        obs.add_span("save.prologue", t0, time.perf_counter(), step=step,
                     flow=obs.flow_id("save", step))
        self._inflight.append(future)
        self._inflight = [f for f in self._inflight if not f.persisted] \
            + [f for f in self._inflight if f.persisted][-1:]
        self._commit_events[step] = threading.Event()
        self._commit_q.put(future)
        if blocking:
            future.wait_persisted()
            self.wait_for_commit(step)
        return future

    def _group_commit(self, future: CheckpointFuture) -> None:
        """Phase 1 and 2 of a group save, on every rank's committer: this
        rank's vote (its file durable, sizes and checksums), every rank's
        outcome gathered, then rank 0 commits the manifest and every rank
        learns whether it did. A rank whose save failed still meets the
        gather, so no rank waits for it."""
        import torch.distributed as dist

        from repro_torch.storage.manifest import RankManifest

        from .baselines import rank_file
        me, world = self._group_rank, self._group_world
        vote: Dict[str, Any]
        try:
            future.wait_persisted()
            name = os.path.basename(rank_file(future.directory, me))
            RankManifest.build(
                future.directory, rank=me, world=world, step=future.step,
                filenames=[name], device=self.device,
                checksum=self.repository.checksum,
                precomputed=future.stats.extra.get("file_checksums")
            ).write(future.directory)
            st = future.stats
            vote = {"ok": True, "n_files": st.n_files,
                    "n_tensors": st.n_tensors,
                    "bytes_tensors": st.bytes_tensors,
                    "bytes_objects": st.bytes_objects,
                    "file_checksums": st.extra.get("file_checksums") or {},
                    "domains": st.extra.get("domains") or {},
                    "file_domains": st.extra.get("file_domains") or {}}
        except BaseException as exc:  # noqa: BLE001 — voted as a failure
            vote = {"ok": False, "error": repr(exc)}
        votes: List[Any] = [None] * world
        dist.all_gather_object(votes, vote, group=self._group)
        future.stats.extra["group_votes"] = votes
        outcome = [None]
        if me == 0:
            failed = [(r, v["error"]) for r, v in enumerate(votes)
                      if not v["ok"]]
            try:
                if failed:
                    raise CheckpointError(f"step {future.step}: ranks "
                                          f"failed their save: {failed}")
                self._commit_group_step(future, votes)
                outcome[0] = None
            except BaseException as exc:  # noqa: BLE001 — every rank
                outcome[0] = repr(exc)
                self.repository.abort_step(future.step)
        dist.broadcast_object_list(outcome, src=0, group=self._group)
        if outcome[0] is not None:
            raise CheckpointError(f"step {future.step}: group commit "
                                  f"failed: {outcome[0]}")

    def _commit_group_step(self, future: CheckpointFuture,
                           votes: List[Dict[str, Any]]) -> None:
        tc0 = time.perf_counter()
        domains: Dict[str, Any] = {}
        for v in votes:
            for dom, e in v["domains"].items():
                d = domains.setdefault(dom, {"providers": [], "codecs": []})
                for key in ("providers", "codecs"):
                    d[key] += [x for x in e.get(key, []) if x not in d[key]]
        meta: Dict[str, Any] = {
            key: sum(v[key] for v in votes)
            for key in ("n_files", "n_tensors", "bytes_tensors",
                        "bytes_objects")}
        meta["save"] = {"blocking_s": future.stats.blocking_s,
                        "capture_s": future.stats.capture_latency_s,
                        "persist_s": future.stats.persist_latency_s,
                        "persist_to_commit_s":
                            tc0 - future.stats.t_persisted}
        if domains:
            meta["domains"] = domains
            meta["file_domains"] = {k: e for v in votes
                                    for k, e in v["file_domains"].items()}
        meta["file_checksums"] = {k: c for v in votes
                                  for k, c in v["file_checksums"].items()}
        self.repository.commit_step(
            future.step, engine_mode=self.mode,
            expect_ranks=self._group_world,
            writers=list(range(self._group_world)), meta=meta)
        tc1 = time.perf_counter()
        future.stats.commit_s = tc1 - tc0
        future.stats.t_committed = tc1

    # -------------------------------------------------------- barriers
    def wait_for_capture(self) -> float:
        """Consistency barrier before the in-place optimizer update.

        Returns the time actually spent blocked — this is the *direct stall*
        the paper measures in Fig 8."""
        t0 = time.perf_counter()
        for f in self._inflight:
            f.wait_captured()
        return time.perf_counter() - t0

    def wait_for_persist(self) -> float:
        t0 = time.perf_counter()
        for f in self._inflight:
            f.wait_persisted()
        return time.perf_counter() - t0

    def wait_for_commit(self, step: Optional[int] = None,
                        timeout: Optional[float] = None) -> None:
        """Block until ``step`` (or every pending step) has its catalog
        manifest committed (or its save is known failed). Settled steps
        are pruned from the pending map, so an already-committed step
        returns immediately."""
        if step is not None:
            events = [self._commit_events.get(step)]
        else:
            events = list(self._commit_events.values())
        for ev in events:
            if ev is None:
                continue  # already settled (or never saved here)
            if not ev.wait(timeout):
                raise TimeoutError("manifest commit did not complete in time")

    # ---------------------------------------------------------- committer
    def _commit_lane(self) -> None:
        # file checksums the writers did not stream are computed here, on
        # a stream of the lane's own, off the training step's stream
        with lane_stream(self.device):
            self._commit_worker()

    def _commit_worker(self) -> None:
        while True:
            future = self._commit_q.get()
            if future is None:
                self._commit_q.task_done()
                return
            try:
                if self._group is not None:
                    self._group_commit(future)
                    continue
                try:
                    future.wait_persisted()
                except BaseException:  # engine failed: orphan, not commit
                    self.repository.abort_step(future.step)
                    if self._delta_tracker is not None:
                        self._delta_tracker.invalidate()
                else:
                    tc0 = time.perf_counter()
                    meta = {"n_files": future.stats.n_files,
                            "n_tensors": future.stats.n_tensors,
                            "bytes_tensors": future.stats.bytes_tensors,
                            "bytes_objects": future.stats.bytes_objects,
                            # save-phase timings ride the manifest so
                            # `storage.cli stats` works on any repository,
                            # long after the in-process stats are gone
                            "save": {
                                "blocking_s": future.stats.blocking_s,
                                "capture_s":
                                    future.stats.capture_latency_s,
                                "persist_s":
                                    future.stats.persist_latency_s,
                                "persist_to_commit_s":
                                    tc0 - future.stats.t_persisted,
                            }}
                    dmeta = future.stats.extra.get("delta")
                    if dmeta is not None:
                        # chain gate: a delta may only commit onto a
                        # committed base — the committer runs FIFO, so the
                        # base's outcome is already settled here. A failed
                        # base makes this step unrestorable; keep it an
                        # invisible orphan instead of blessing it.
                        base = dmeta.get("base_step")
                        if not dmeta.get("keyframe", True) \
                                and (base is None or
                                     not self.repository.has_manifest(base)):
                            raise CheckpointError(
                                f"step {future.step}: delta base step "
                                f"{base} never committed — refusing to "
                                f"commit a broken chain")
                        meta["delta"] = dmeta
                    doms = future.stats.extra.get("domains")
                    if doms:
                        meta["domains"] = doms
                        # per-file maps, known since plan time: lets the
                        # manifest fill FileEntry.domains without re-
                        # parsing footers (StepManifest.build pops this —
                        # it is never stored in the manifest meta itself)
                        fdoms = future.stats.extra.get("file_domains")
                        if fdoms:
                            meta["file_domains"] = fdoms
                    # per-file checksums accumulated by the writers while
                    # persisting — StepManifest.build pops this and reuses
                    # them instead of re-reading every byte on the commit
                    # lane (never stored in the manifest meta itself)
                    fsums = future.stats.extra.get("file_checksums")
                    if fsums:
                        meta["file_checksums"] = fsums
                    # Multi-rank saves commit with their full topology:
                    # the phase-2 gate re-validates every surviving
                    # rank's vote and every node manifest before the
                    # step becomes visible.
                    self.repository.commit_step(
                        future.step, engine_mode=self.mode,
                        expect_ranks=future.stats.extra.get("world"),
                        writers=future.stats.extra.get("writers"),
                        nodes=future.stats.extra.get("nodes"),
                        meta=meta)
                    tc1 = time.perf_counter()
                    future.stats.commit_s = tc1 - tc0
                    future.stats.t_committed = tc1
                    obs_metrics.observe("commit.latency_s", tc1 - tc0)
                    obs.add_span("commit", tc0, tc1, step=future.step,
                                 flow=obs.flow_id("save", future.step),
                                 flow_phase="end")
            except BaseException as exc:  # noqa: BLE001
                self.commit_errors.append((future.step, repr(exc)))
                # a failed commit leaves the step an orphan (marker still
                # present); retract the active claim so GC can reclaim it
                self.repository.abort_step(future.step)
                if self._delta_tracker is not None:
                    self._delta_tracker.invalidate()
            finally:
                # prune-then-set: anyone already holding the event still
                # wakes, and the pending map stays bounded over long runs
                ev = self._commit_events.pop(future.step, None)
                if ev is not None:
                    ev.set()
                self._commit_q.task_done()

    # ------------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        return self.repository.latest_step()

    def restore(self, template: Any, step: Optional[int] = None,
                engine: Optional[RestoreEngine] = None,
                fallback: Optional[bool] = None,
                domains: Optional[Sequence[str]] = None) -> Any:
        """Rebuild ``template``-shaped state from a stored checkpoint.

        ``template`` tensor leaves give each restored leaf its shape, dtype
        and device: a CUDA template restores onto the card. A
        :class:`~repro_torch.sharding.ShardedTensor` leaf is reassembled
        shard by shard onto its mesh (elastic — the target layout need not
        match the stored one, so a run can resume onto a different mesh
        or world).

        ``domains`` selects named state domains (top-level template keys):
        ``restore(state, domains=("model",))`` plans and reads *only* the
        model sub-tree's byte ranges — ``last_restore_stats.bytes_read``
        is the audit — and returns the full template with unrequested
        domains untouched.

        Step selection goes through the repository: with ``step=None`` the
        committed steps are tried newest→oldest (``fallback`` defaults on),
        so a checkpoint damaged *after* commit is skipped in favor of the
        previous complete one; an explicit ``step`` is restored exactly
        (``fallback`` defaults off) and surfaces its own error. Either way
        a step evicted from the local tier is re-hydrated from the policy's
        remote tiers (tier-by-tier fallback).

        The heavy lifting is done by the parallel
        :class:`~repro_torch.core.restore.RestoreEngine`: the step directory
        is indexed once, the shard/target intersections are planned up
        front, and only the intersecting byte ranges are read — ranged
        positional reads fanned out over a thread pool — into preallocated
        host buffers. Restore is format-universal (native ``.dsllm``,
        snapshot chunk manifests, sync pickle graphs), so a run can also
        switch engines between save and resume. Per-restore timings and
        I/O counts are left in :attr:`last_restore_stats`."""
        # Saves requested through this manager may have persisted but not
        # yet committed their manifest; settle the catalog before reading
        # it so a just-finished step is eligible.
        self.wait_for_commit()
        tree, stats, s = restore_from_repository(
            self.repository, template, step=step,
            engine=engine or self.restore_engine, fallback=fallback,
            domains=domains,
            verify_chain=(self.delta_policy is None
                          or self.delta_policy.verify_chain_on_restore))
        self.last_restore_stats = stats
        self.last_restored_step = s
        return tree

    # -------------------------------------------------------------- misc
    def drain(self) -> None:
        # settle every in-flight save without raising: a failed save must
        # not wedge shutdown (its error already surfaced to the caller via
        # wait_for_persist/wait_for_capture and commit_errors)
        for f in self._inflight:
            f._persisted.wait()
        if self.engine is not None:
            self.engine.drain()
        if self.coordinator is not None:
            self.coordinator.drain()
        self._commit_q.join()
        self.repository.drain()

    def close(self) -> None:
        self.drain()
        self._commit_q.put(None)
        self._committer.join(timeout=60)
        if self.engine is not None:
            self.engine.close()
        if self.coordinator is not None:
            self.coordinator.close()
        self.repository.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
