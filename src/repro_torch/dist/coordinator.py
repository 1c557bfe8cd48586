"""Multi-rank checkpoint coordinator: hierarchical two-phase commit.

The paper's evaluation (§VI) is fundamentally multi-writer — every rank of
the DP×TP×PP mesh drains its own shards concurrently, and the throughput
gain comes from all ranks' I/O lanes running at once. This module owns the
save *protocol*; the execution domain behind each rank is pluggable
(:mod:`repro_torch.dist.runtime`):

* :class:`ThreadRankRuntime` — one thread per rank in this process. The
  deterministic test double every protocol test runs against.
* :class:`~repro_torch.dist.process_runtime.ProcessRankRuntime` — one spawned
  OS process per rank (``runtime="process"``): a SIGKILL'd rank takes
  down exactly one process, the way a preempted node would.

The save protocol, per step:

1. **partition** — :func:`partition_records` maps the (already
   replica-balanced, see ``core.distributed.plan_shards``) shard records
   onto writer ranks, preserving device locality when there are at least
   as many devices as ranks and balancing by byte count otherwise. Ranks
   known dead are evicted first and their slice is re-spread over the
   survivors by byte balance (:func:`assign_replica_writers` with the
   survivors' loads as the initial fill), so the *next* save after a rank
   loss still commits with every shard present.
2. **phase 1 (prepare)** — each rank persists its ``rankNNNNN.dsllm``
   file through its own engine lane, then atomically writes its
   :class:`~repro_torch.storage.manifest.RankManifest` vote.
3. **hierarchical ack collective** — ranks meet their *node-local*
   barrier first (:class:`_NodeCommit`, one per ``node_size`` block of
   ranks); each node's aggregator (its lowest rank) then writes the
   node's :class:`~repro_torch.storage.manifest.NodeManifest` — the subtree
   vote — and meets the *global* barrier. Fan-in at any barrier is
   O(node_size) or O(n_nodes), never O(world); a dead or stalled rank is
   isolated and reported at its own aggregator (its node barrier is
   poisoned with the victim named), while surviving subtrees drain
   cleanly and observe the failure at the global barrier.
4. **phase 2 (commit)** — only once the global collective completes does
   the aggregated :class:`~repro_torch.core.engine.CheckpointFuture` report
   ``persisted``; the manager's committer lane then writes the global
   ``StepManifest`` atomically last, re-validating every rank vote *and*
   every node manifest before making the step visible.

A crash, stall, or lie at *any* point before phase 2 leaves the step as an
in-flight orphan the catalog never selects — the single-writer crash
consistency of the repository, preserved under N concurrent writers.

Every rank's engine, vote checksums and node aggregation run on the
coordinator's ``device`` (the card unless the caller asks for the CPU):
the thread ranks and the process ranks' proxies each enter a stream of
their own there (``kernels.ops.lane_stream``).

``fault_hook`` is the thread runtime's deterministic fault-injection seam
(``tests/test_torch_dist.py``): called at named protocol points
(``"mid_file"``, ``"after_upload"``, ``"before_ack"``) with the rank and
save context, it may raise (kill) or block (stall) the rank there. The
process runtime takes a picklable
:class:`~repro_torch.dist.ipc.ProcessFaultSpec` via ``fault=`` instead — a
closure cannot cross a process boundary, and a *real* SIGKILL needs no
cooperation from the victim.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import (Any, Callable, Dict, Iterable, List, Optional, Sequence,
                    Set, Tuple)

import torch

from repro_torch.analysis.locks import declares_lock
from repro_torch.core.baselines import merge_domains_meta, rank_file
from repro_torch.core.distributed import ShardRecord, assign_replica_writers
from repro_torch.core.engine import CheckpointFuture, join_lanes
from repro_torch.core.state_provider import DeltaSaveSpec
from repro_torch.kernels.ops import lane_stream
from repro_torch.obs import trace as obs
from repro_torch.obs.metrics import metrics as obs_metrics
from repro_torch.storage.manifest import NodeManifest, RankManifest

from .barrier import CollectiveBarrier
from .ipc import ProcessFaultSpec
from .runtime import RANK_ENGINES, BaseRankRuntime

# Named fault-injection points of the thread runtime, in protocol order.
FAULT_POINTS = ("mid_file", "after_upload", "before_ack")

#: Rank-runtime backends (see module docstring).
RUNTIME_KINDS = ("thread", "process")

#: Default commit-tree fan-in: ranks per node when ``node_size`` is not
#: given. Worlds up to this size commit through one node and one
#: aggregator, the flat protocol.
DEFAULT_NODE_SIZE = 8

FaultHook = Callable[[str, int, Dict[str, Any]], None]


def partition_records(records: Sequence[ShardRecord], world: int,
                      *, dead: Iterable[int] = ()
                      ) -> Dict[int, List[ShardRecord]]:
    """Map shard records onto ``world`` writer ranks.

    With at least as many owning devices as ranks, whole device groups are
    kept together (rank ← sorted-device-position mod world) — each rank
    drains "its" devices' shards, the paper's locality. With fewer devices
    than ranks (e.g. a single-host simulation), individual records are
    spread greedily by byte count, largest first, onto the least-loaded
    rank, so every lane gets ~1/world of the bytes.

    ``dead`` names ranks evicted from the writer set (watchdog-confirmed
    process deaths). The base partition is computed over the *full* world
    first — so surviving ranks keep exactly the slice they always had
    (their per-rank delta bases stay valid) — and only the dead ranks'
    orphaned records are re-spread over the survivors, by byte balance
    seeded with the survivors' existing loads
    (:func:`~repro_torch.core.distributed.assign_replica_writers`). Every
    surviving rank appears in the result (possibly with an empty list):
    each must write its file and cast its phase-1 vote, or the step
    cannot commit.
    """
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    dead_set = {int(d) for d in dead}
    if not dead_set.issubset(range(world)):
        raise ValueError(
            f"dead ranks {sorted(dead_set - set(range(world)))} outside "
            f"world {world}")
    survivors = [r for r in range(world) if r not in dead_set]
    if not survivors:
        raise RuntimeError(
            f"no surviving writer ranks (world={world}, "
            f"dead={sorted(dead_set)})")
    out: Dict[int, List[ShardRecord]] = {r: [] for r in range(world)}
    by_dev: Dict[int, List[ShardRecord]] = {}
    for rec in records:
        by_dev.setdefault(rec.rank, []).append(rec)
    if len(by_dev) >= world:
        for pos, dev in enumerate(sorted(by_dev)):
            out[pos % world].extend(by_dev[dev])
    else:
        load = {r: 0 for r in range(world)}
        for rec in sorted(records,
                          key=lambda r: (-r.nbytes, r.tensor_name)):
            r = min(load, key=lambda k: (load[k], k))
            out[r].append(rec)
            load[r] += rec.nbytes
    if not dead_set:
        return out
    orphaned: List[ShardRecord] = []
    for d in sorted(dead_set):
        orphaned.extend(out.pop(d))
    live_load = {r: sum(rec.nbytes for rec in out[r]) for r in survivors}
    owners = assign_replica_writers(
        [(rec.tensor_name, rec.nbytes, {s: None for s in survivors})
         for rec in orphaned],
        initial_load=live_load)
    for rec in orphaned:
        out[owners[rec.tensor_name]].append(rec)
    return out


def node_topology(world: int, node_size: Optional[int] = None
                  ) -> Dict[int, List[int]]:
    """Commit-tree layout: ``{node_id: [member ranks]}``, contiguous
    blocks of ``node_size`` ranks (mirroring how ranks land on hosts)."""
    size = DEFAULT_NODE_SIZE if node_size is None else int(node_size)
    if size < 1:
        raise ValueError(f"node_size must be >= 1, got {node_size}")
    size = min(size, world)
    return {nid: list(range(nid * size, min((nid + 1) * size, world)))
            for nid in range((world + size - 1) // size)}


@declares_lock("coordinator.node", rank=15, attrs=("lock",))
class _NodeCommit:
    """One node of the commit tree: members, aggregator, local barrier.

    The aggregator (the node's lowest rank) is the only member that
    proceeds past the node barrier: it writes the node's subtree vote
    (:class:`~repro_torch.storage.manifest.NodeManifest`) and represents the
    node at the global barrier. ``arrived`` (under ``lock``) names who
    reached the ack point, so a watchdog firing can poison each straggler
    node with exactly its missing members.
    """

    def __init__(self, node_id: int, ranks: Sequence[int]):
        self.node_id = node_id
        self.ranks: Tuple[int, ...] = tuple(sorted(ranks))
        self.aggregator = self.ranks[0]
        self.lock = threading.Lock()
        self.arrived: Set[int] = set()
        self.barrier = CollectiveBarrier(len(self.ranks))


# Outermost lock: rank callbacks fire with no repo/engine lock held, and
# all barrier/repository work happens after this lock is dropped.
@declares_lock("coordinator.job", rank=10, attrs=("lock",))
class _SaveJob:
    """Shared per-save state: capture/ack aggregation onto one future,
    through the node-local → global barrier hierarchy."""

    def __init__(self, step: int, directory: str, world: int,
                 writers: Sequence[int], nodes: Dict[int, Sequence[int]],
                 future: CheckpointFuture,
                 ack_timeout_s: Optional[float],
                 device: torch.device,
                 checksum_votes: bool = True):
        self.step = step
        self.device = device
        self.directory = directory
        self.world = world
        self.writers: Tuple[int, ...] = tuple(sorted(writers))
        self.future = future
        self.ack_timeout_s = ack_timeout_s
        self.checksum_votes = checksum_votes
        self.nodes: Dict[int, _NodeCommit] = {
            nid: _NodeCommit(nid, ranks)
            for nid, ranks in sorted(nodes.items()) if ranks}
        self.node_of: Dict[int, _NodeCommit] = {
            r: nc for nc in self.nodes.values() for r in nc.ranks}
        if set(self.node_of) != set(self.writers):
            raise ValueError(
                f"node topology {sorted(self.node_of)} does not cover "
                f"writers {list(self.writers)}")
        # fan-in at the root is O(n_nodes), not O(world)
        self.global_barrier = CollectiveBarrier(len(self.nodes))
        self.lock = threading.Lock()
        self.n_captured = 0
        self.failed = False
        self.settled = False
        self.watchdog_done = False
        self.timer: Optional[threading.Timer] = None
        # the state's producers on the caller's stream: a rank's copies
        # and the process ranks' shipping wait for them, whatever stream
        # or thread they run on
        self.ready: Optional[torch.cuda.Event] = None
        if device.type == "cuda":
            self.ready = torch.cuda.Event()
            self.ready.record(torch.cuda.current_stream(device))

    # -- rank-side callbacks -------------------------------------------------
    def rank_captured(self, rank: int, fut: Optional[CheckpointFuture]
                      ) -> None:
        with self.lock:
            self.n_captured += 1
            done = (self.n_captured == len(self.writers)
                    and not self.failed)
        if done and not self.future.captured:
            self.future._set_captured()

    def _merge_stats(self, rank: int, fut: CheckpointFuture) -> None:
        s, d = fut.stats, self.future.stats
        with self.lock:
            d.n_files += s.n_files
            d.n_tensors += s.n_tensors
            d.bytes_tensors += s.bytes_tensors
            d.bytes_objects += s.bytes_objects
            d.serialize_s += s.serialize_s
            d.stage_s += s.stage_s
            d.flush_s += s.flush_s
            doms = s.extra.get("domains")
            if doms:
                # per-rank engines derive their domain routing summaries
                # from their own provider instances; the aggregate future
                # carries the union for the step-level manifest record
                merge_domains_meta(d.extra.setdefault("domains", {}), doms)
            fdoms = s.extra.get("file_domains")
            if fdoms:
                # filenames are unique per rank, so a plain update merges
                d.extra.setdefault("file_domains", {}).update(fdoms)
            for key in ("device_peak_bytes", "kernel_launches"):
                # a process rank's own peak device memory and its kernel
                # launches in this save, by rank (thread ranks share the
                # caller's process, and its counts)
                if key in s.extra:
                    d.extra.setdefault(key, {})[rank] = s.extra[key]

    def rank_acked(self, rank: int, fut: Optional[CheckpointFuture]
                   ) -> None:
        """Phase-1 vote cast: meet the hierarchical ack collective.

        Every rank meets its *node* barrier; only the node's aggregator
        continues — it writes the node manifest (the subtree's vote) and
        meets the global barrier. The save's future turns ``persisted``
        only when every node's aggregator reaches the root — the gate
        the committer (phase 2) waits behind."""
        if fut is not None:
            self._merge_stats(rank, fut)
        node = self.node_of[rank]
        with node.lock:
            node.arrived.add(rank)
        node.barrier.wait(timeout=self.ack_timeout_s)
        if rank != node.aggregator:
            return
        # whole subtree prepared: cast the node vote, then meet the root
        with obs.span("node.vote", lane=f"rank{node.aggregator:05d}",
                      step=self.step, node=node.node_id):
            nm = NodeManifest.build(
                self.directory, node=node.node_id,
                ranks=list(node.ranks), step=self.step, world=self.world,
                device=self.device, checksum=self.checksum_votes)
            nm.write(self.directory)
        self.global_barrier.wait(timeout=self.ack_timeout_s)
        with self.lock:
            # mark done *before* cancel: a Timer whose callback already
            # started survives .cancel(), and _on_timeout re-checks this
            # flag under the same lock — closing the fire-vs-cancel race
            self.watchdog_done = True
            settle = not self.failed and not self.settled
            self.settled = self.settled or settle
        if settle:
            self._cancel_watchdog()
            self.future._set_persisted()

    def rank_failed(self, rank: int, exc: BaseException) -> None:
        with self.lock:
            first = not self.failed and not self.settled
            self.failed = True
        if not first:
            return
        node = self.node_of.get(rank)
        if node is not None:
            # isolate the failure at the victim's own aggregator: only
            # this node's members wake with the cause; sibling subtrees
            # finish phase 1 + their node vote, then observe the poisoned
            # root
            node.barrier.poison(
                f"rank {rank} failed during save of step {self.step}: "
                f"{exc!r}", rank=rank)
            root_cause = (f"node {node.node_id} (rank {rank}) failed "
                          f"during save of step {self.step}: {exc!r}")
        else:
            # watchdog (rank=-1): name each straggler node's missing
            # members at its own barrier
            root_cause = (f"save of step {self.step} failed: {exc!r}")
            for nc in self.nodes.values():
                with nc.lock:
                    missing = sorted(set(nc.ranks) - nc.arrived)
                if missing:
                    nc.barrier.poison(
                        f"node {nc.node_id}: ranks {missing} never "
                        f"acked step {self.step}: {exc!r}")
        self.global_barrier.poison(root_cause,
                                   rank=rank if rank >= 0 else None)
        self._cancel_watchdog()
        self.future._set_error(exc)

    # -- coordinator side ----------------------------------------------------
    def start_watchdog(self) -> None:
        """Arm the ack timeout. Called by the *first rank to dequeue* the
        job, not at submit: the manager pipelines saves, and a job can sit
        behind an earlier step in the rank FIFOs for longer than the
        timeout — the watchdog must bound save latency (first rank
        starting → last ack), never queue wait."""
        if self.ack_timeout_s is None:
            return
        with self.lock:
            if self.timer is not None or self.settled or self.failed:
                return
            self.timer = threading.Timer(self.ack_timeout_s,
                                         self._on_timeout)
            self.timer.daemon = True
            self.timer.start()

    def _on_timeout(self) -> None:
        with self.lock:
            # the done flag is the authority, not Timer.cancel(): cancel
            # cannot stop a callback that has already been scheduled, so
            # a save that fully acked in the cancel window must not be
            # retro-failed here
            if self.watchdog_done or self.settled or self.failed:
                return
        self.rank_failed(-1, TimeoutError(
            f"step {self.step}: not all ranks acked within "
            f"{self.ack_timeout_s}s — a writer is stalled or dead"))

    def _cancel_watchdog(self) -> None:
        with self.lock:
            timer = self.timer
        if timer is not None:
            timer.cancel()


class ThreadRankRuntime(BaseRankRuntime):
    """One simulated writer rank: a thread + its own engine/cache lane.

    The protocol test double — same :class:`_SaveJob` callbacks as the
    process backend, but faults are injected with in-process closures
    (``fault_hook``) and a "killed" rank is an exception, not a corpse.
    """

    def __init__(self, rank: int, world: int, *, device: torch.device,
                 mode: str = "datastates",
                 host_cache_bytes: int = 1 << 30, flush_threads: int = 2,
                 chunk_bytes: int = 4 << 20,
                 throttle_mbps: Optional[float] = None,
                 checksum_files: bool = True,
                 fault_hook: Optional[FaultHook] = None):
        if mode not in RANK_ENGINES:
            raise ValueError(
                f"coordinator ranks require a DataMovementEngine mode, "
                f"got {mode!r} (choose from {sorted(RANK_ENGINES)})")
        self.rank = rank
        self.world = world
        self.device = torch.device(device)
        self.checksum_files = checksum_files
        self.fault_hook = fault_hook
        # distinct lane-name prefix per rank: traces get one set of engine
        # tracks (stage/producer/flush) per rank lane
        self.lane = f"rank{rank:05d}"
        self.engine = RANK_ENGINES[mode](
            device=self.device,
            host_cache_bytes=host_cache_bytes, flush_threads=flush_threads,
            chunk_bytes=chunk_bytes, throttle_mbps=throttle_mbps,
            label=self.lane, checksum_files=checksum_files)
        self._q: "queue.Queue[Optional[tuple]]" = queue.Queue()
        self._thread = threading.Thread(
            target=self._worker, daemon=True, name=f"dsllm-rank-{rank}")
        self._thread.start()

    @property
    def host_cache(self):
        return self.engine.host_cache

    def submit(self, job: _SaveJob, records: List[ShardRecord],
               objects: Dict[str, Any],
               delta: Optional[DeltaSaveSpec] = None) -> None:
        self._q.put((job, records, objects, delta))

    # ------------------------------------------------------------- internals
    def _fault(self, point: str, job: _SaveJob, files: List[str]) -> None:
        if self.fault_hook is not None:
            self.fault_hook(point, self.rank, {
                "step": job.step, "directory": job.directory,
                "files": [os.path.join(job.directory, n) for n in files]})

    def _worker(self) -> None:
        # the rank's checksum launches run on a stream of their own
        with lane_stream(self.device):
            self._serve()

    def _serve(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            job, records, objects, delta = item
            try:
                self._run_save(job, records, objects, delta)
            except BaseException as exc:  # noqa: BLE001
                job.rank_failed(self.rank, exc)
            finally:
                self._q.task_done()

    def _run_save(self, job: _SaveJob, records: List[ShardRecord],
                  objects: Dict[str, Any],
                  delta: Optional[DeltaSaveSpec] = None) -> None:
        job.start_watchdog()  # first rank to dequeue arms the ack timeout
        if job.ready is not None:
            # this lane's copies are enqueued on its own stream: order
            # them after the caller's updates of the state
            torch.cuda.current_stream(self.device).wait_event(job.ready)
        fut = CheckpointFuture(job.step, job.directory)
        flow = obs.flow_id("save", job.step, rank=self.rank)
        # phase 1a: drain this rank's shards through this rank's lane.
        # Differential saves keep *per-rank* delta bases: each rank's
        # engine retains the previous snapshot of exactly the shards it
        # writes (the partition is deterministic for an unchanged shard
        # set, and any reshard forces a keyframe upstream).
        self.engine.save(job.directory, {self.rank: records}, objects, fut,
                        delta=delta)
        with obs.span("rank.capture_wait", lane=self.lane, step=job.step,
                      rank=self.rank, flow=flow, flow_phase="start"):
            fut.wait_captured()
        job.rank_captured(self.rank, fut)
        with obs.span("rank.persist_wait", lane=self.lane, step=job.step,
                      rank=self.rank, flow=flow):
            fut.wait_persisted()
        files = [os.path.basename(rank_file(job.directory, self.rank))]
        self._fault("mid_file", job, files)
        self._fault("after_upload", job, files)
        # phase 1b: the vote — sizes + checksums hashed on this lane
        with obs.span("vote", lane=self.lane, step=job.step,
                      rank=self.rank, flow=flow):
            vote = RankManifest.build(
                job.directory, rank=self.rank, world=job.world,
                step=job.step, filenames=files, device=self.device,
                checksum=self.checksum_files,
                precomputed=fut.stats.extra.get("file_checksums"))
            vote.write(job.directory)
        self._fault("before_ack", job, files)
        t_ack = time.perf_counter()
        job.rank_acked(self.rank, fut)
        t_done = time.perf_counter()
        obs_metrics.observe("barrier.wait_s", t_done - t_ack)
        obs.add_span("ack.barrier", t_ack, t_done, lane=self.lane,
                     step=job.step, rank=self.rank, flow=flow,
                     flow_phase="end")

    def drain(self) -> None:
        self._q.join()
        self.engine.drain()

    def close(self) -> None:
        self._q.put(None)
        self.engine.close()
        join_lanes([self._thread])


@declares_lock("coordinator.dead", rank=12, attrs=("_dead_lock",))
class Coordinator:
    """Owns N rank runtimes and the save protocol across them."""

    def __init__(self, world: int, *, device: torch.device = "cuda",
                 mode: str = "datastates",
                 runtime: str = "thread",
                 node_size: Optional[int] = None,
                 host_cache_bytes: int = 1 << 30, flush_threads: int = 2,
                 chunk_bytes: int = 4 << 20,
                 throttle_mbps: Optional[float] = None,
                 checksum_files: bool = True,
                 ack_timeout_s: Optional[float] = None,
                 fault_hook: Optional[FaultHook] = None,
                 fault: Optional[ProcessFaultSpec] = None,
                 torch_distributed: bool = False):
        """``torch_distributed``: each process rank joins the
        ``torch.distributed`` group its environment configures (the
        reference's ``jax_distributed``); process runtime only."""
        from repro_torch.core.checkpoint import resolve_device

        if world < 1:
            raise ValueError(f"world must be >= 1, got {world}")
        if runtime not in RUNTIME_KINDS:
            raise ValueError(f"unknown runtime {runtime!r} "
                             f"(choose from {RUNTIME_KINDS})")
        self.world = world
        self.device = resolve_device(device)
        self.mode = mode
        self.runtime = runtime
        self.node_size = node_size
        self.nodes = node_topology(world, node_size)
        self.ack_timeout_s = ack_timeout_s
        self.checksum_files = checksum_files
        self._dead_lock = threading.Lock()
        self.dead_ranks: Set[int] = set()
        if runtime == "thread":
            if torch_distributed:
                raise ValueError("torch_distributed=True requires "
                                 "runtime='process': thread ranks share "
                                 "one process")
            if fault is not None:
                raise ValueError(
                    "fault= (ProcessFaultSpec) requires runtime="
                    "'process'; the thread runtime injects faults with "
                    "fault_hook= closures")
            self.ranks: List[BaseRankRuntime] = [
                ThreadRankRuntime(
                    r, world, device=self.device, mode=mode,
                    host_cache_bytes=host_cache_bytes,
                    flush_threads=flush_threads, chunk_bytes=chunk_bytes,
                    throttle_mbps=throttle_mbps,
                    checksum_files=checksum_files, fault_hook=fault_hook)
                for r in range(world)]
        else:
            if fault_hook is not None:
                raise ValueError(
                    "fault_hook= closures cannot cross a process "
                    "boundary; use fault= (a ProcessFaultSpec) with "
                    "runtime='process'")
            from .process_runtime import ProcessRankRuntime
            self.ranks = [
                ProcessRankRuntime(
                    r, world, device=self.device, mode=mode,
                    host_cache_bytes=host_cache_bytes,
                    flush_threads=flush_threads, chunk_bytes=chunk_bytes,
                    throttle_mbps=throttle_mbps,
                    checksum_files=checksum_files,
                    fault=fault if fault is not None
                    and fault.rank == r else None,
                    on_dead=self._note_dead,
                    torch_distributed=torch_distributed)
                for r in range(world)]

    # ------------------------------------------------------- writer census
    def _note_dead(self, rank: int) -> None:
        with self._dead_lock:
            self.dead_ranks.add(rank)

    def _prune_dead(self) -> Set[int]:
        for rt in self.ranks:
            live = rt.alive()
            if not live:
                with self._dead_lock:
                    self.dead_ranks.add(rt.rank)
        with self._dead_lock:
            return set(self.dead_ranks)

    def active_writers(self) -> Tuple[int, ...]:
        """Surviving writer ranks, re-checking liveness first. The
        manager consults this before planning a delta save: a changed
        writer set moves shard slices between engines, which invalidates
        every per-rank delta base (forced keyframe)."""
        dead = self._prune_dead()
        return tuple(r for r in range(self.world) if r not in dead)

    def submit(self, step: int, directory: str,
               records: Sequence[ShardRecord], objects: Dict[str, Any],
               future: CheckpointFuture,
               delta: Optional[DeltaSaveSpec] = None) -> Dict[str, Any]:
        """Fan one save out across the surviving ranks. Returns
        immediately with the save's commit topology — ``{"writers":
        [...], "nodes": {node_id: [ranks]}}`` — which the manager stashes
        on the future so phase 2 validates exactly the votes this save
        was built to cast. The aggregated ``future`` captures when every
        writer has captured and persists only when every node's
        aggregator has met the global barrier (phase 1 complete — the
        committer performs phase 2 behind it). ``delta`` (a
        :class:`DeltaSaveSpec`) puts the save on the differential path:
        every rank streams XOR deltas against its own retained bases, and
        the step commits through the same hierarchical vote.

        Per-domain provider routing (the manager's
        :class:`~repro_torch.core.registry.StateProviderRegistry`) needs no
        extra plumbing here: each record carries its resolved
        :class:`~repro_torch.core.registry.ProviderRoute`, so every rank lane
        builds the same tensor/delta/quantized/custom providers for its
        partition that a single-writer engine would."""
        dead = self._prune_dead()
        writers = [r for r in range(self.world) if r not in dead]
        by_rank = partition_records(records, self.world, dead=dead)
        # objects ride with the least-loaded rank (deterministic tie-break)
        loads = {r: sum(rec.nbytes for rec in by_rank[r]) for r in writers}
        obj_rank = min(loads, key=lambda r: (loads[r], r))
        nodes = {nid: [r for r in ranks if r not in dead]
                 for nid, ranks in self.nodes.items()}
        nodes = {nid: ranks for nid, ranks in nodes.items() if ranks}
        # One barrier tree per save: the manager pipelines steps, and
        # ranks reach the ack point of different steps at different
        # times — shared barriers would mix generations across steps.
        job = _SaveJob(step, directory, self.world, writers, nodes,
                       future, self.ack_timeout_s, self.device,
                       checksum_votes=self.checksum_files)
        for r in writers:
            self.ranks[r].submit(job, by_rank[r],
                                 objects if r == obj_rank else {},
                                 delta=delta)
        return {"writers": list(writers),
                "nodes": {nid: list(ranks)
                          for nid, ranks in sorted(nodes.items())}}

    def drain(self) -> None:
        for rank in self.ranks:
            rank.drain()

    def close(self) -> None:
        for rank in self.ranks:
            rank.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
