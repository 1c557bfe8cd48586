"""Streamlined multi-tier data-movement engine (paper §V-A1, §V-A2, §V-A4).

The engine consumes chunk streams from composable state providers and moves
them across tiers using separate physical paths in parallel:

* a **staging lane**: the blocking prologue launches, for every CUDA
  tensor, one non-blocking copy per chunk into its pre-reserved pinned-cache
  slice on a dedicated copy stream (which first waits for the caller's
  stream, so it sees the finished update) and records an event per chunk;
  the staging thread synchronizes those events in order and notifies the
  provider after each one, so downstream flushing begins before a tensor
  has fully landed. Tensors on the CPU are copied chunk by chunk by the
  staging thread itself;
* **producer lanes** (one per checkpoint file): iterate the composite
  provider's chunk stream — tensors first, then lazily-serialized objects —
  and enqueue write ops;
* a **flush pool** (models liburing/O_DIRECT writers): positional
  ``os.pwrite`` workers, multiple files in flight, GIL-released.

Completion is tracked per request as two phases (paper Fig 6(c,d)):
``captured`` (all device state has left the device — safe to mutate, i.e. the
optimizer update may run) and ``persisted`` (all files durable, footer
written).
"""

from __future__ import annotations

import functools
import os
import queue
import threading
import time
from typing import (Any, Callable, Dict, List, Optional, Sequence, Set,
                    Tuple)

import numpy as np
import torch

from repro_torch.analysis.locks import declares_lock, named_lock
from repro_torch.kernels.ops import lane_stream
from repro_torch.obs import trace as obs
from repro_torch.obs.metrics import metrics as obs_metrics

from .host_cache import HostCache
from .layout import FileWriter
from .state_provider import (Chunk, CompositeStateProvider,
                             TensorStateProvider, DEFAULT_CHUNK_BYTES)


class CheckpointError(RuntimeError):
    pass


class CheckpointStats:
    """Wall-clock phase timings, used by the benchmark harness."""

    def __init__(self) -> None:
        self.t_request: float = 0.0         # save() entered
        self.blocking_s: float = 0.0        # time training was blocked in save()
        self.t_captured: float = 0.0
        self.t_persisted: float = 0.0
        self.bytes_tensors: int = 0
        self.bytes_objects: int = 0
        self.n_files: int = 0
        self.n_tensors: int = 0
        self.serialize_s: float = 0.0       # object serialization time
        self.stage_s: float = 0.0           # device->host staging time
        self.flush_s: float = 0.0           # cumulative pwrite time
        self.t_committed: float = 0.0       # catalog manifest durable
        self.commit_s: float = 0.0          # manifest build+write duration
        self.extra: Dict[str, Any] = {}

    @property
    def capture_latency_s(self) -> float:
        return self.t_captured - self.t_request

    @property
    def persist_latency_s(self) -> float:
        return self.t_persisted - self.t_request

    @property
    def commit_latency_s(self) -> float:
        return self.t_committed - self.t_request

    @property
    def total_bytes(self) -> int:
        return self.bytes_tensors + self.bytes_objects


class CheckpointFuture:
    """Two-phase completion handle for one checkpoint request."""

    def __init__(self, step: int, directory: str):
        self.step = step
        self.directory = directory
        self.stats = CheckpointStats()
        self._captured = threading.Event()
        self._persisted = threading.Event()
        self._error: Optional[BaseException] = None

    # -- engine side ---------------------------------------------------------
    def _set_captured(self) -> None:
        self.stats.t_captured = time.perf_counter()
        self._captured.set()

    def _set_persisted(self) -> None:
        self.stats.t_persisted = time.perf_counter()
        self._persisted.set()

    def _set_error(self, exc: BaseException) -> None:
        self._error = exc
        self._captured.set()
        self._persisted.set()

    # -- user side -----------------------------------------------------------
    @property
    def captured(self) -> bool:
        return self._captured.is_set()

    @property
    def persisted(self) -> bool:
        return self._persisted.is_set()

    def _check(self) -> None:
        if self._error is not None:
            raise CheckpointError(
                f"checkpoint step={self.step} failed") from self._error

    def wait_captured(self, timeout: Optional[float] = None) -> None:
        if not self._captured.wait(timeout):
            raise TimeoutError("capture did not complete in time")
        self._check()

    def wait_persisted(self, timeout: Optional[float] = None) -> None:
        if not self._persisted.wait(timeout):
            raise TimeoutError("persist did not complete in time")
        self._check()


class FilePlan:
    """One checkpoint file: a composite provider + destination path."""

    def __init__(self, path: str, composite: CompositeStateProvider,
                 meta: Optional[Dict[str, Any]] = None):
        self.path = path
        self.composite = composite
        self.meta = meta or {}


class _WriteOp:
    __slots__ = ("writer", "chunk", "file_state", "throttle", "on_written")

    def __init__(self, writer, chunk, file_state, throttle, on_written=None):
        self.writer = writer
        self.chunk = chunk
        self.file_state = file_state
        self.throttle = throttle
        self.on_written = on_written


@declares_lock("engine.file_state", rank=52, attrs=("lock",))
class _FileState:
    """Per-file pending-op accounting to decide when to finalize."""

    def __init__(self, plan: FilePlan, writer: FileWriter,
                 on_done: Callable[[], None], future: "CheckpointFuture"):
        self.plan = plan
        self.writer = writer
        self.on_done = on_done
        self.future = future
        self.lock = threading.Lock()
        self.pending = 0
        self.producer_done = False
        self.failed = False  # producer died: discard instead of finalize
        # partial object payload assembly (chunked log appends)
        self.object_parts: Dict[str, List[bytes]] = {}
        # release tracking for device-resident tensor providers: chunk
        # writes in flight, and the tensors whose last chunk is queued
        self.tensor_pending: Dict[str, int] = {}
        self.tensor_all_queued: Set[str] = set()

    def op_started(self) -> None:
        with self.lock:
            self.pending += 1

    def op_finished(self) -> bool:
        with self.lock:
            self.pending -= 1
            done = self.producer_done and self.pending == 0
        if done:
            self.on_done()
        return done

    def chunk_queued(self, name: str, last: bool) -> None:
        with self.lock:
            self.tensor_pending[name] = self.tensor_pending.get(name, 0) + 1
            if last:
                self.tensor_all_queued.add(name)

    def chunk_written(self, name: str) -> bool:
        """Count one written chunk of tensor ``name``; True once its last
        chunk is queued and no chunk of it is in flight."""
        with self.lock:
            self.tensor_pending[name] -= 1
            return self.tensor_pending[name] == 0 \
                and name in self.tensor_all_queued

    def producer_finished(self) -> None:
        with self.lock:
            done = self.pending == 0
            self.producer_done = True
        if done:
            self.on_done()


#: how long ``close`` waits for a lane to take its stop sentinel
LANE_JOIN_TIMEOUT_S = 60.0


def join_lanes(threads: Sequence[threading.Thread]) -> None:
    """Wait for lanes that were sent their stop sentinel. A daemon lane
    that has run PyTorch code and is still alive when the interpreter
    finalizes (woken by its sentinel a moment too late) is torn down
    inside PyTorch's C++ frames, which aborts the process ("terminate
    called without an active exception"); so an owner joins its lanes
    before it returns from ``close``."""
    for t in threads:
        t.join(timeout=LANE_JOIN_TIMEOUT_S)


class DataMovementEngine:
    """The full DataStates-LLM engine (lazy capture + streamlined flush)."""

    def __init__(self, device: torch.device,
                 host_cache_bytes: int = 2 << 30,
                 flush_threads: int = 4,
                 producer_threads: int = 2,
                 chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                 throttle_mbps: Optional[float] = None,
                 track_file_checksums: bool = False,
                 label: str = "dsllm"):
        self.device = torch.device(device)
        # pinned on a card, so the device-to-host copies are true async DMA
        self.host_cache = HostCache(host_cache_bytes,
                                    pin_memory=self.device.type == "cuda")
        self._copy_stream: Optional[torch.cuda.Stream] = None
        self.chunk_bytes = chunk_bytes
        self.throttle_mbps = throttle_mbps
        # accumulate manifest-compatible per-file checksums while writing
        # (one pass): the commit lane reuses them instead of re-reading
        # every persisted byte
        self.track_file_checksums = track_file_checksums
        # ``label`` prefixes the lane (thread) names — the coordinator gives
        # each rank's engine a distinct prefix so traces get per-rank lanes.
        self.label = label
        self._flush_q: "queue.Queue[Optional[_WriteOp]]" = queue.Queue()
        self._stage_q: "queue.Queue[Optional[Tuple]]" = queue.Queue()
        self._producer_q: "queue.Queue[Optional[Tuple]]" = queue.Queue()
        self._shutdown = False
        self._flush_threads = [
            threading.Thread(target=self._in_lane(self._flush_worker),
                             daemon=True, name=f"{label}-flush-{i}")
            for i in range(flush_threads)]
        self._stage_thread = threading.Thread(
            target=self._in_lane(self._stage_worker), daemon=True,
            name=f"{label}-stage")
        self._producer_threads = [
            threading.Thread(target=self._in_lane(self._producer_worker),
                             daemon=True, name=f"{label}-producer-{i}")
            for i in range(producer_threads)]
        for t in (*self._flush_threads, self._stage_thread,
                  *self._producer_threads):
            t.start()

    # ------------------------------------------------------------------ API
    def submit(self, files: Sequence[FilePlan],
               capture_items: Sequence[Tuple[TensorStateProvider, Any]],
               future: CheckpointFuture) -> None:
        """Kick off one checkpoint request.

        ``capture_items`` are (provider, tensor) pairs needing staging into
        the host cache. This call performs only the *blocking* prologue:
        coalesced cache reservation (back-pressure lives here) and the
        launch of the chunked non-blocking device-to-host copies —
        everything else proceeds on background lanes.
        """
        stats = future.stats
        # --- coalesced reservation: all shards of the checkpoint up front
        # (pre-allocated, pre-pinned pool; §V-A1). Fail fast if one full
        # checkpoint version can never fit: the paper sizes the cache to
        # hold at least one version per node (§VI-C2, 80 GB/node) — waiting
        # here would deadlock (nothing is flushing yet, so nothing frees).
        total = sum(p.nbytes for p, _ in capture_items)
        if total > self.host_cache.capacity:
            raise CheckpointError(
                f"checkpoint device payload ({total/2**20:.0f} MiB) exceeds "
                f"host cache ({self.host_cache.capacity/2**20:.0f} MiB); "
                f"raise host_cache_bytes — the cache must hold one full "
                f"checkpoint version (paper §VI-C2)")
        bound: List[TensorStateProvider] = []
        try:
            for provider, _arr in capture_items:
                provider.bind_reservation(
                    self.host_cache.reserve(provider.nbytes))
                bound.append(provider)
            # --- launch non-blocking D2H for every CUDA tensor (lazy
            # capture; overlaps with the next iteration's forward/backward,
            # §V-A2).
            staged_events = self._launch_d2h(capture_items)
        except BaseException:
            # Prologue failed mid-way: nothing was enqueued yet, so no lane
            # will ever drain these reservations — release them here or the
            # pinned pool leaks and the next save deadlocks in reserve().
            for provider in bound:
                try:
                    provider.release()
                except BaseException:
                    pass
            raise
        for plan in files:
            stats.n_files += 1
            comp = plan.composite
            stats.n_tensors += len(comp.tensor_providers)
            stats.bytes_tensors += sum(p.nbytes for p in comp.tensor_providers)

        pending_files = {"n": len(files)}
        lock = named_lock("engine.save_progress", rank=50)

        def file_done() -> None:
            with lock:
                pending_files["n"] -= 1
                last = pending_files["n"] == 0
            if last and not future.persisted:
                future._set_persisted()

        capture_pending = {"n": len(capture_items)}

        def one_staged() -> None:
            with lock:
                capture_pending["n"] -= 1
                done = capture_pending["n"] == 0
            if done and not future.captured:
                future._set_captured()

        if not capture_items:
            future._set_captured()
        for provider, arr in capture_items:
            self._stage_q.put((provider, arr,
                               staged_events.get(id(provider)), one_staged,
                               future))
        for plan in files:
            self._producer_q.put((plan, file_done, future))
        if not files:
            future._set_persisted()

    def _launch_d2h(self, capture_items) -> Dict[int, List[Tuple[int, Any]]]:
        """Enqueue one ``copy_(non_blocking=True)`` per chunk of every CUDA
        tensor into its pinned reservation, on the engine's copy stream,
        and record an event after each chunk. Returns ``{id(provider):
        [(staged_end, event), ...]}``; CPU tensors are left to the staging
        thread."""
        out: Dict[int, List[Tuple[int, Any]]] = {}
        cuda_items = [(p, t) for p, t in capture_items
                      if isinstance(t, torch.Tensor) and t.is_cuda]
        if not cuda_items:
            return out
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(
                device=cuda_items[0][1].device)
        stream = self._copy_stream
        # the copies must see every write the caller's stream has queued
        # (the optimizer update that produced this state)
        stream.wait_stream(torch.cuda.current_stream(stream.device))
        step = self.chunk_bytes
        with torch.cuda.stream(stream):
            for provider, t in cuda_items:
                src = t.detach().reshape(-1).view(torch.uint8)
                # t lives on the caller's stream: keep its memory from
                # being reused before the copies on this stream are done
                t.record_stream(stream)
                dst = provider.reservation.tensor()
                events = []
                for pos in range(0, provider.nbytes, step):
                    end = min(pos + step, provider.nbytes)
                    dst[pos:end].copy_(src[pos:end], non_blocking=True)
                    ev = torch.cuda.Event()
                    ev.record(stream)
                    events.append((end, ev))
                out[id(provider)] = events
        return out

    def drain(self) -> None:
        """Wait for all queued work (tests/benchmarks)."""
        self._stage_q.join()
        self._producer_q.join()
        self._flush_q.join()

    def close(self) -> None:
        self._shutdown = True
        for _ in self._producer_threads:
            self._producer_q.put(None)
        self._stage_q.put(None)
        for _ in self._flush_threads:
            self._flush_q.put(None)
        join_lanes((*self._producer_threads, self._stage_thread,
                    *self._flush_threads))

    # ------------------------------------------------------------ workers
    def _in_lane(self, worker: Callable[[], None]) -> Callable[[], None]:
        """``worker`` run on a stream of its own (:func:`lane_stream`): the
        encode lanes' copies, kernels and read-backs stay off the stream
        the training step computes on."""
        def run() -> None:
            with lane_stream(self.device):
                worker()
        return run

    def _stage_worker(self) -> None:
        """The D2H lane: waits for each CUDA tensor's chunk events in order
        (copying CPU tensors itself), notifying the provider as chunks
        land in their cache reservations."""
        while True:
            item = self._stage_q.get()
            if item is None:
                self._stage_q.task_done()
                return
            provider, arr, events, one_staged, future = item
            try:
                t0 = time.perf_counter()
                n = provider.nbytes
                # a legacy provider flushes only once the whole tensor is
                # staged: it hears of it once, below
                stream = provider.stream_intra_tensor
                if events is not None:
                    for end, ev in events:
                        ev.synchronize()
                        if stream:
                            provider.notify_staged(end)
                else:
                    src = arr.detach().reshape(-1).view(torch.uint8) \
                        .numpy() if isinstance(arr, torch.Tensor) \
                        else np.asarray(arr).reshape(-1).view(np.uint8)
                    dst = provider.reservation.array(np.uint8, (n,))
                    step = self.chunk_bytes
                    for pos in range(0, n, step):
                        end = min(pos + step, n)
                        dst[pos:end] = src[pos:end]
                        if stream:
                            provider.notify_staged(end)  # flush the head
                provider.notify_staged(n)
                t1 = time.perf_counter()
                future.stats.stage_s += t1 - t0
                obs_metrics.inc("engine.bytes_staged", n)
                obs.add_span("d2h.stage", t0, t1, tensor=provider.name,
                             bytes=n, step=future.step,
                             flow=obs.flow_id("save", future.step))
                one_staged()
            except BaseException as exc:  # noqa: BLE001
                future._set_error(exc)
            finally:
                self._stage_q.task_done()

    def _producer_worker(self) -> None:
        """Iterate one file's chunk stream and enqueue write ops."""
        while True:
            item = self._producer_q.get()
            if item is None:
                self._producer_q.task_done()
                return
            plan, file_done, future = item
            try:
                with obs.span("produce.file", step=future.step,
                              file=os.path.basename(plan.path),
                              flow=obs.flow_id("save", future.step)):
                    self._produce_file(plan, file_done, future)
            except BaseException as exc:  # noqa: BLE001
                future._set_error(exc)
            finally:
                self._producer_q.task_done()

    def _produce_file(self, plan: FilePlan, file_done, future) -> None:
        layout = plan.composite.plan_layout()
        writer = FileWriter(plan.path, layout,
                            track_checksum=self.track_file_checksums)
        state = _FileState(plan, writer,
                           on_done=lambda: self._finalize_file(
                               state, file_done, future), future=future)
        try:
            for k, v in plan.meta.items():
                writer.set_meta(k, v)
            # Encoded (delta / quantized / custom) tensors never reach the
            # fixed region: declare their footer metadata up front; their
            # compressed chunks are appended by the flush lanes as they
            # land.
            for p in plan.composite.encoded_providers():
                writer.declare_encoded_tensor(
                    p.name, dtype=p.dtype, shape=p.shape, nbytes=p.nbytes,
                    codec=getattr(p, "enc_codec", "raw"),
                    global_shape=p.global_shape, index=p.index)
            providers = {p.name: p for p in plan.composite.tensor_providers}
            for chunk in plan.composite.chunks():
                if chunk.kind == "object":
                    # assemble chunked payload; single contiguous log append
                    parts = state.object_parts.setdefault(chunk.name, [])
                    parts.append(bytes(chunk.data))
                    if chunk.last:
                        payload = b"".join(state.object_parts.pop(chunk.name))
                        future.stats.bytes_objects += len(payload)
                        state.op_started()
                        self._flush_q.put(_WriteOp(
                            writer,
                            Chunk(name=chunk.name, kind="object",
                                  data=payload, codec=chunk.codec, last=True),
                            state, self.throttle_mbps))
                else:
                    state.op_started()
                    on_written = None
                    p = providers.get(chunk.name)
                    if p is not None and p.device_resident:
                        # evict from the pinned cache once every chunk of
                        # the tensor is written: the flush lanes finish
                        # chunks out of order, and a raw chunk is a view
                        # of the reservation the next save reuses
                        state.chunk_queued(chunk.name, chunk.last)
                        on_written = functools.partial(
                            self._chunk_written, state, p)
                    self._flush_q.put(_WriteOp(writer, chunk, state,
                                               self.throttle_mbps,
                                               on_written))
        except BaseException:
            # Producer failed mid-stream: the file has no footer and never
            # will. Mark the file failed and let the per-file accounting
            # drain normally — when the last queued op finishes,
            # _finalize_file aborts/unlinks the partial file. Closing the
            # fd right here would race in-flight pwrites: the kernel can
            # recycle the fd number into another open file and a stale
            # positional write would corrupt it.
            state.failed = True
            state.producer_finished()
            raise
        state.producer_finished()

    @staticmethod
    def _chunk_written(state: "_FileState",
                       provider: TensorStateProvider) -> None:
        if state.chunk_written(provider.name):
            provider.release()

    @staticmethod
    def _discard_partial(writer: FileWriter) -> None:
        """Abort a writer and remove its footer-less partial file."""
        writer.abort()
        try:
            os.unlink(writer.path)
        except OSError:
            pass

    @staticmethod
    def _release_providers(state: "_FileState") -> None:
        """Free the pinned-cache reservations of a failed file's tensors.

        On the happy path each provider releases via its last chunk's
        ``on_written``; an error path skips those callbacks, and a leaked
        reservation would make the next save block forever inside the
        cache allocator. ``release`` is idempotent, so double-freeing the
        already-flushed providers is safe."""
        for p in state.plan.composite.tensor_providers:
            try:
                p.release()
            except BaseException:  # noqa: BLE001
                pass

    def _finalize_file(self, state: "_FileState", file_done, future) -> None:
        writer = state.writer
        if state.failed or future._error is not None:
            # The producer died or some op already failed the request:
            # never write a footer over a partial file.
            self._discard_partial(writer)
            self._release_providers(state)
            return
        try:
            writer.finalize()
        except BaseException as exc:  # noqa: BLE001
            self._discard_partial(writer)
            self._release_providers(state)
            future._set_error(exc)
            return
        if writer.file_checksum is not None:
            # one finalize per file; dict.setdefault/__setitem__ are atomic
            # under the GIL, and each file writes a distinct key
            future.stats.extra.setdefault("file_checksums", {})[
                os.path.basename(writer.path)] = writer.file_checksum
        file_done()

    def _flush_worker(self) -> None:
        """liburing-style positional writers; GIL released inside pwrite."""
        while True:
            op = self._flush_q.get()
            if op is None:
                self._flush_q.task_done()
                return
            try:
                t0 = time.perf_counter()
                chunk = op.chunk
                nb_written = None
                if chunk.kind == "object":
                    op.writer.append_object(chunk.name, chunk.data,
                                            codec=chunk.codec)
                elif chunk.codec != "raw":
                    # codec-aware flush stage (differential checkpointing):
                    # compress the XOR-delta payload here — off the capture
                    # and producer paths — and log-append it.
                    from .reduction import _compress
                    payload = _compress(bytes(chunk.data))
                    t_enc = time.perf_counter()
                    obs.add_span("encode.compress", t0, t_enc,
                                 tensor=chunk.name, codec=chunk.codec,
                                 bytes_in=len(chunk.data),
                                 bytes_out=len(payload))
                    op.writer.append_encoded_chunk(chunk.name, payload,
                                                   *chunk.raw_range,
                                                   digest=chunk.digest)
                    nb_written = len(payload)
                else:
                    op.writer.write_at(chunk.offset, chunk.data)
                    if chunk.digest is not None \
                            and chunk.raw_range is not None:
                        # keyframe/raw chunk saved under manifest
                        # checksums: record the producer's per-chunk
                        # digest so verify can localize a flipped chunk
                        op.writer.record_raw_chunk(
                            chunk.name, *chunk.raw_range, chunk.digest)
                if nb_written is not None:
                    nb = nb_written
                elif isinstance(chunk.data, bytes):
                    nb = len(chunk.data)
                else:
                    nb = chunk.data.nbytes
                if op.throttle:
                    target = nb / (op.throttle * 1e6)
                    elapsed = time.perf_counter() - t0
                    if target > elapsed:
                        time.sleep(target - elapsed)
                t1 = time.perf_counter()
                fut = op.file_state.future
                fut.stats.flush_s += t1 - t0
                obs_metrics.inc(
                    "engine.bytes_written." + (chunk.codec or "raw"), nb)
                obs.add_span("flush", t0, t1, chunk=chunk.name, bytes=nb,
                             step=fut.step,
                             flow=obs.flow_id("save", fut.step))
                if op.on_written is not None:
                    op.on_written()
                op.file_state.op_finished()
            except BaseException as exc:  # noqa: BLE001
                op.file_state.future._set_error(exc)
                # keep the per-file op accounting moving so the last op
                # reaches _finalize_file, which (seeing the error) aborts
                # the writer and removes the partial file instead of
                # leaking the fd behind a footer-less file.
                try:
                    op.file_state.op_finished()
                except BaseException:  # noqa: BLE001
                    pass
            finally:
                # credit the producer's encode budget on every outcome —
                # a failed write must not starve the (blocked) producer
                if op.chunk.on_flushed is not None:
                    try:
                        op.chunk.on_flushed()
                    except BaseException:  # noqa: BLE001
                        pass
                self._flush_q.task_done()
