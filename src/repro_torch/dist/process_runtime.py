"""Process-per-rank backend: one spawned OS process per writer rank.

The thread runtime shares one address space, so a "dead rank" there is a
raised exception — python cannot actually kill a thread, and a real rank
loss (preemption, OOM-kill, node crash) kills a *process* with no chance
to run cleanup. This backend gives every rank its own spawned child
(:mod:`repro_torch.dist.worker`) and keeps a parent-side **proxy thread** per
rank that speaks the save protocol on the child's behalf:

* ``submit`` enqueues; the proxy ships the encoded partition over the
  pipe, and calls ``rank_captured`` as soon as ``send()`` returns — the
  payload is fully serialized out of the training buffers at that point,
  which is exactly what the capture barrier promises;
* the proxy then waits on **both** the pipe and the child's process
  sentinel (``multiprocessing.connection.wait``): a ``prepared`` reply
  becomes ``rank_acked`` (the proxy meets the barriers in-parent), a
  ``failed`` reply becomes :class:`~repro_torch.dist.ipc.RemoteRankError`, and
  the sentinel firing — the SIGKILL case — becomes
  :class:`~repro_torch.dist.ipc.ProcessDied`, reported to the job like any
  rank failure and to the coordinator's dead-rank set via ``on_dead``;
* child trace spans ship back in each reply and are ingested into the
  parent tracer with a clock offset measured at the ``ready`` handshake,
  so one Perfetto export shows every process's lanes on one timeline.

Children are spawned, never forked: a fork after CUDA has started in the
parent breaks the child's CUDA. With ``torch_distributed`` each child
first joins the ``torch.distributed`` group the environment configures
(:func:`repro_torch.dist.worker.join_process_group`, the reference's
``jax_distributed``). Each child builds its engine on the
parent's device. On a card the proxy waits for the event the save
recorded on the caller's stream before it copies the shards to the host,
and the node aggregation it may run enters a stream of its own.

A save abandoned by the watchdog (stalled child) leaves its reply
in-flight; replies are tagged with their step and stale ones are drained
before the next ship, so a late ``prepared`` can never ack the wrong
save.
"""

from __future__ import annotations

import multiprocessing
import queue
import threading
import time
from multiprocessing import connection as mp_connection
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.analysis.locks import declares_lock
from repro_torch.core.engine import CheckpointFuture, join_lanes
from repro_torch.kernels.ops import lane_stream
from repro_torch.obs import trace as obs
from repro_torch.obs.metrics import metrics as obs_metrics

from .ipc import (ProcessDied, ProcessFaultSpec, RemoteRankError,
                  apply_stats, encode_record, send_arrays)
from .runtime import RANK_ENGINES, BaseRankRuntime
from .worker import worker_main

#: How often the proxy re-checks job state / child liveness while waiting
#: for a reply, and how long a graceful shutdown waits before close()
#: escalates to terminate/kill.
_POLL_S = 0.2
_SHUTDOWN_GRACE_S = 5.0


@declares_lock("ipc.proc", rank=16, attrs=("_lock",))
class ProcessRankRuntime(BaseRankRuntime):
    """One writer rank as a spawned child + parent-side proxy thread."""

    def __init__(self, rank: int, world: int, *, device: torch.device,
                 mode: str = "datastates",
                 host_cache_bytes: int = 1 << 30, flush_threads: int = 2,
                 chunk_bytes: int = 4 << 20,
                 throttle_mbps: Optional[float] = None,
                 checksum_files: bool = True,
                 fault: Optional[ProcessFaultSpec] = None,
                 on_dead: Optional[Callable[[int], None]] = None,
                 torch_distributed: bool = False):
        if mode not in RANK_ENGINES:
            raise ValueError(
                f"coordinator ranks require a DataMovementEngine mode, "
                f"got {mode!r} (choose from {sorted(RANK_ENGINES)})")
        self.rank = rank
        self.world = world
        self.device = torch.device(device)
        self.checksum_files = checksum_files
        self.lane = f"rank{rank:05d}"
        self._on_dead = on_dead
        self._dead = threading.Event()
        self._lock = threading.Lock()   # guards _closed vs teardown races
        self._closed = False
        self._clock_offset = 0.0
        self._pid: Optional[int] = None
        #: the world of the process group the child joined (``None``: it
        #: joined none), known after the ``ready`` handshake
        self.group_world: Optional[int] = None
        engine_kw = dict(host_cache_bytes=host_cache_bytes,
                         flush_threads=flush_threads,
                         chunk_bytes=chunk_bytes,
                         throttle_mbps=throttle_mbps,
                         checksum_files=checksum_files)
        ctx = multiprocessing.get_context("spawn")
        self._conn, child_conn = ctx.Pipe(duplex=True)
        self._proc = ctx.Process(
            target=worker_main,
            args=(child_conn, rank, world, mode, str(self.device),
                  engine_kw, checksum_files, fault, torch_distributed),
            daemon=True, name=f"dsllm-rankproc-{rank}")
        self._proc.start()
        child_conn.close()  # parent keeps exactly one end
        self._q: "queue.Queue[Optional[tuple]]" = queue.Queue()
        self._proxy = threading.Thread(
            target=self._proxy_loop, daemon=True,
            name=f"dsllm-rankproxy-{rank}")
        self._proxy.start()

    # ------------------------------------------------------------ interface
    def submit(self, job: Any, records: List[Any],
               objects: Dict[str, Any], delta: Optional[Any] = None
               ) -> None:
        self._q.put((job, records, objects, delta))

    def alive(self) -> bool:
        with self._lock:
            closed = self._closed
        return (not closed and not self._dead.is_set()
                and self._proc.is_alive())

    def drain(self) -> None:
        self._q.join()

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._q.put(None)
        join_lanes([self._proxy])
        if self._proc.is_alive():
            self._proc.terminate()
            self._proc.join(timeout=_SHUTDOWN_GRACE_S)
            if self._proc.is_alive():
                self._proc.kill()
                self._proc.join(timeout=_SHUTDOWN_GRACE_S)
        try:
            self._conn.close()
        except OSError:
            pass

    # ---------------------------------------------------------- proxy loop
    def _proxy_loop(self) -> None:
        # a node aggregator's vote checksums run on a stream of their own
        with lane_stream(self.device):
            self._serve()

    def _serve(self) -> None:
        try:
            self._handshake()
        except (ProcessDied, EOFError, OSError):
            self._mark_dead()
        while True:
            item = self._q.get()
            if item is None:
                self._shutdown_child()
                self._q.task_done()
                return
            job, records, objects, delta = item
            try:
                self._run_remote_save(job, records, objects, delta)
            except BaseException as exc:  # noqa: BLE001
                job.rank_failed(self.rank, exc)
            finally:
                self._q.task_done()

    def _handshake(self) -> None:
        """Wait for the child's ``ready`` and align its trace clock."""
        while True:
            ready = mp_connection.wait(
                [self._conn, self._proc.sentinel], timeout=None)
            if self._conn in ready:
                try:
                    msg = self._conn.recv()
                except EOFError:
                    raise self._died()
                if msg[0] == "ready":
                    self._pid = msg[1]
                    self.group_world = msg[3]
                    # perf_counter is per-process on some OSes; the
                    # offset maps child span times onto this process's
                    # timeline (≈ pipe latency where clocks are shared)
                    self._clock_offset = time.perf_counter() - msg[2]
                    return
                continue
            if self._proc.sentinel in ready:
                raise self._died()

    def _run_remote_save(self, job: Any, records: List[Any],
                         objects: Dict[str, Any], delta: Optional[Any]
                         ) -> None:
        if not self.alive():
            raise self._died()
        job.start_watchdog()  # first rank to dequeue arms the ack timeout
        while self._conn.poll(0):  # drop stale replies of abandoned saves
            try:
                self._conn.recv()
            except EOFError:
                raise self._died()
        flow = obs.flow_id("save", job.step, rank=self.rank)
        t0 = time.perf_counter()
        if job.ready is not None:
            job.ready.synchronize()  # the caller's updates of the state
        payload = [encode_record(r) for r in records]
        arrays = []
        for p in payload:  # the bytes follow the message, in pieces
            arrays.append(p["data"])
            p["data"] = (p["data"].dtype.str, p["data"].shape)
        try:
            self._conn.send(("save", job.step, job.directory, payload,
                             objects, delta, obs.enabled()))
            send_arrays(self._conn, arrays)
        except (OSError, ValueError, BrokenPipeError):
            raise self._died()
        t1 = time.perf_counter()
        obs.add_span("rank.ship", t0, t1, lane=self.lane, step=job.step,
                     rank=self.rank, flow=flow, flow_phase="start")
        # payload fully serialized out of the training buffers: the
        # capture promise holds even though the child hasn't staged yet
        job.rank_captured(self.rank, None)
        reply = self._await_reply(job)
        if reply is None:
            return  # job already failed (watchdog); wait abandoned
        if reply[0] == "failed":
            _, _step, exc_repr, tb, events = reply
            self._ingest_events(events)
            raise RemoteRankError(self.rank, exc_repr, tb)
        _, _step, stats, events = reply
        self._ingest_events(events)
        fut = CheckpointFuture(job.step, job.directory)
        apply_stats(fut.stats, stats)
        t_ack = time.perf_counter()
        job.rank_acked(self.rank, fut)
        t_done = time.perf_counter()
        obs_metrics.observe("barrier.wait_s", t_done - t_ack)
        obs.add_span("ack.barrier", t_ack, t_done, lane=self.lane,
                     step=job.step, rank=self.rank, flow=flow,
                     flow_phase="end")

    def _await_reply(self, job: Any) -> Optional[tuple]:
        """Reply for ``job``, ``None`` if the job failed first, or raise
        :class:`ProcessDied` when the sentinel/EOF says the child is
        gone."""
        while True:
            ready = mp_connection.wait(
                [self._conn, self._proc.sentinel], timeout=_POLL_S)
            if self._conn in ready:
                try:
                    msg = self._conn.recv()
                except EOFError:
                    raise self._died()
                if msg[0] in ("prepared", "failed") \
                        and msg[1] != job.step:
                    continue  # stale reply from an abandoned save
                return msg
            if self._proc.sentinel in ready:
                self._proc.join(timeout=1.0)
                raise self._died()
            if job.future.persisted:
                # the job settled without this rank's reply, which can
                # only mean it settled with an error (this rank is a
                # party to its node barrier): the watchdog fired. Stop
                # waiting so the queue drains; the reply, if it ever
                # arrives, is dropped as stale by the next save.
                return None

    def _died(self) -> ProcessDied:
        self._mark_dead()
        return ProcessDied(self.rank, self._proc.exitcode)

    def _mark_dead(self) -> None:
        if not self._dead.is_set():
            self._dead.set()
            if self._on_dead is not None:
                self._on_dead(self.rank)

    def _ingest_events(self, events: List[Dict[str, Any]]) -> None:
        tracer = obs.get_tracer()
        if tracer is None or not events:
            return
        tracer.ingest(events, clock_offset=self._clock_offset,
                      default_lane=self.lane)

    def _shutdown_child(self) -> None:
        if self._dead.is_set() or not self._proc.is_alive():
            return
        try:
            self._conn.send(("close",))
        except (OSError, ValueError, BrokenPipeError):
            return
        deadline = time.monotonic() + _SHUTDOWN_GRACE_S
        while time.monotonic() < deadline:
            ready = mp_connection.wait(
                [self._conn, self._proc.sentinel], timeout=_POLL_S)
            if self._proc.sentinel in ready:
                break
            if self._conn in ready:
                try:
                    if self._conn.recv()[0] == "closed":
                        break
                except EOFError:
                    break
        self._proc.join(timeout=_SHUTDOWN_GRACE_S)
