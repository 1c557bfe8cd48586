"""Checkpoint engines: DataStates-LLM and the paper's three baselines (§VI-B).

All engines implement :class:`BaseCheckpointEngine` and fill the same
:class:`~repro_torch.core.engine.CheckpointStats`, so the four can be
compared head to head as the paper's figures do. Names and on-disk
formats are the JAX package's, so either package restores the other's
steps.

* :class:`SyncSerializedEngine` — "DeepSpeed default": blocking,
  type-agnostic serialization of the full object graph (tensors copied to
  the host and through the pickler), one synchronous write per rank
  file. (Fig 6(a))
* :class:`SnapshotThenFlushEngine` — "TorchSnapshot": blocking up-front
  object serialization, a blocking device-to-host copy of *all* shards
  into freshly allocated pageable host memory (never the pinned cache),
  then background multi-threaded writes of one file per 64 MiB chunk.
  (Fig 6(b))
* :class:`DataStatesOldEngine` — HPDC'24 prior work: the pinned cache, lazy
  capture and async flush, but objects are serialized in a blocking
  prologue and a tensor flushes only once it is wholly staged (no
  intra-tensor streaming). (Fig 6(c))
* :class:`DataStatesEngine` — this paper: composable state providers
  (zero-copy tensors, lazy object serialization overlapped with bulk I/O,
  XOR deltas against a retained snapshot, int8-quantized fp32 state) over
  the streamlined :class:`DataMovementEngine`, with intra-tensor
  stage/flush streaming. (Fig 6(d))
"""

from __future__ import annotations

import os
import pickle
import queue
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.storage.backend import atomic_write

from . import dtypes, pickle_compat
from .distributed import ShardRecord
from .engine import CheckpointError, CheckpointFuture, DataMovementEngine, \
    FilePlan, join_lanes
from .layout import maybe_fsync
from .state_provider import (CompositeStateProvider, DeltaSaveSpec,
                             DeltaStateProvider, EncodeBudget,
                             ObjectStateProvider, QuantizedStateProvider,
                             SnapshotCache, TensorStateProvider)


def resolve_provider(rec: ShardRecord, delta: Optional[DeltaSaveSpec]):
    """Resolve one shard record's registry route to a concrete provider
    kind: ``(kind, factory)`` where kind is a stock name and factory is
    the user callable for custom providers (else None). ``"auto"`` (and
    records without a route) adapts to the save mode: delta when the save
    is differential, raw otherwise — the pre-registry behavior."""
    route = rec.route
    if route is None or (route.provider == "auto" and route.factory is None):
        return ("delta" if delta is not None else "tensor"), None
    return route.provider, route.factory


def _object_domain(key: str) -> Optional[str]:
    """State-domain of an object-log key (None for engine-internal keys
    like ``__checkpoint_meta__``)."""
    parts = key.split("/")
    name = parts[1] if len(parts) > 1 else parts[0]
    return None if name.startswith("__") else name


def merge_domains_meta(dst: Dict[str, Dict[str, List[str]]],
                       src: Dict[str, Dict[str, List[str]]]
                       ) -> Dict[str, Dict[str, List[str]]]:
    """Fold one ``{domain: {providers, codecs}}`` map into another
    (union, sorted). Used to aggregate per-file maps into the save-level
    summary and per-rank summaries across coordinator lanes — one
    derivation (from the live provider instances) feeds both the ``.dsllm``
    footers and ``StepManifest.meta['domains']``, so they can never drift."""
    for domain, e in src.items():
        t = dst.setdefault(domain, {"providers": [], "codecs": []})
        for k in ("providers", "codecs"):
            for v in e.get(k, ()):
                if v not in t[k]:
                    t[k].append(v)
            t[k].sort()
    return dst


def _reject_encoded_routes(by_rank, engine_name: str) -> None:
    """Baseline (non-DataMovementEngine) engines stream raw only — a
    registry route to an encoding provider must fail loudly, not be
    silently dropped."""
    for recs in by_rank.values():
        for r in recs:
            if r.route is not None \
                    and r.route.provider not in ("auto", "tensor"):
                raise ValueError(
                    f"engine {engine_name!r} cannot honor provider route "
                    f"{r.route.provider!r} for {r.tensor_name!r}; "
                    f"registry-routed delta/quantized/custom providers "
                    f"require a DataMovementEngine mode "
                    f"(datastates / datastates-old)")


def _host_array(data) -> np.ndarray:
    """A fresh host copy of a shard's values in its storage dtype,
    bfloat16 as :data:`~.dtypes.BF16_HOST` (a blocking copy into pageable
    memory for a CUDA tensor)."""
    if isinstance(data, torch.Tensor):
        return dtypes.host_copy(data.detach())
    return np.array(data, copy=True)


def rank_file(directory: str, rank: int, ext: str = "dsllm") -> str:
    return os.path.join(directory, f"rank{rank:05d}.{ext}")


class BaseCheckpointEngine:
    name = "base"

    def __init__(self, device: torch.device,
                 host_cache_bytes: int = 1 << 30,
                 flush_threads: int = 4, chunk_bytes: int = 4 << 20,
                 throttle_mbps: Optional[float] = None,
                 checksum_files: bool = False,
                 label: str = "dsllm"):
        self.device = torch.device(device)
        self.host_cache_bytes = host_cache_bytes
        self.flush_threads = flush_threads
        self.chunk_bytes = chunk_bytes
        self.throttle_mbps = throttle_mbps
        # manifest checksums are on for this repository: engines that can
        # should produce integrity metadata in-pass (streaming file
        # checksums, fused per-chunk payload digests) so the vote/commit
        # lanes never re-read persisted bytes
        self.checksum_files = checksum_files
        # lane-name prefix for this engine's worker threads (trace tracks)
        self.label = label

    def save(self, directory: str,
             by_rank: Dict[int, List[ShardRecord]],
             objects: Dict[str, Any],
             future: CheckpointFuture,
             delta: Optional[DeltaSaveSpec] = None) -> None:
        raise NotImplementedError

    def drain(self) -> None:
        pass

    def close(self) -> None:
        pass

    # shared helper: simulate limited storage bandwidth if configured
    def _throttle(self, nbytes: int, t0: float) -> None:
        if self.throttle_mbps:
            target = nbytes / (self.throttle_mbps * 1e6)
            elapsed = time.perf_counter() - t0
            if target > elapsed:
                time.sleep(target - elapsed)


# --------------------------------------------------------------------------
class DataStatesEngine(BaseCheckpointEngine):
    """This paper's engine: state providers + streamlined multi-tier flush."""

    name = "datastates"
    _stream_intra_tensor = True
    _blocking_object_serialization = False

    def __init__(self, **kw):
        super().__init__(**kw)
        self._engine = DataMovementEngine(
            self.device, host_cache_bytes=self.host_cache_bytes,
            flush_threads=self.flush_threads,
            chunk_bytes=self.chunk_bytes,
            throttle_mbps=self.throttle_mbps,
            track_file_checksums=self.checksum_files,
            label=self.label)
        # Differential checkpointing: retained previous-snapshot copies,
        # held inside the same pinned host-cache budget as staging.
        self.snapshot_cache = SnapshotCache(self._engine.host_cache)
        # Consecutive delta saves are ordered: save N+1 may only start
        # streaming (mutating the snapshot cache) once save N's providers
        # have finished streaming — tracked as (streamed_event, future).
        self._delta_prev: Optional[tuple] = None
        self._delta_gate_timeout_s = 600.0

    @property
    def host_cache(self):
        return self._engine.host_cache

    def _object_providers(self, objects: Dict[str, Any],
                          future: CheckpointFuture
                          ) -> List[ObjectStateProvider]:
        if not self._blocking_object_serialization:
            # lazy: serialization happens on the producer lane, overlapped
            # with bulk tensor I/O (§V-A5).
            return [ObjectStateProvider(name, obj)
                    for name, obj in objects.items()]
        # legacy engines: serialize everything up front, blocking (§IV-D).
        provs = []
        t0 = time.perf_counter()
        for name, obj in objects.items():
            payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
            provs.append(ObjectStateProvider(name, obj,
                                             preserialized=payload))
        future.stats.serialize_s += time.perf_counter() - t0
        return provs

    # -- differential-save plumbing -----------------------------------------
    def _await_delta_turn(self) -> None:
        """Block (briefly) until the previous delta save has finished
        *streaming* — its providers are done mutating the snapshot cache;
        its flush lanes may still be writing, which is fine."""
        prev = self._delta_prev
        if prev is None:
            return
        streamed, prev_future = prev
        deadline = time.perf_counter() + self._delta_gate_timeout_s
        while not streamed.is_set() \
                and not prev_future._persisted.is_set():
            streamed.wait(0.05)
            if time.perf_counter() > deadline:
                raise CheckpointError(
                    "previous differential save never finished streaming — "
                    "cannot order the snapshot-cache updates of the next one")

    def _delta_precheck(self, delta: DeltaSaveSpec,
                        delta_records: List[ShardRecord],
                        all_records: List[ShardRecord]) -> None:
        """Fail fast instead of deadlocking inside the cache allocator:
        a delta save needs previous-version (snapshot cache — only the
        delta-routed tensors retain one) + in-flight version (staging,
        every device tensor) bytes simultaneously."""
        snap = sum(r.nbytes for r in delta_records)
        stage = sum(r.nbytes for r in all_records if r.device_resident)
        if snap + stage > self._engine.host_cache.capacity:
            raise CheckpointError(
                f"differential checkpointing needs the host cache to hold "
                f"the previous snapshot ({snap/2**20:.0f} MiB) plus the "
                f"in-flight staging copy ({stage/2**20:.0f} MiB); raise "
                f"host_cache_bytes above {(snap+stage)/2**20:.0f} MiB")
        if not delta.keyframe:
            for r in delta_records:
                prev = self.snapshot_cache.view(r.tensor_name)
                if prev is None or len(prev) != r.nbytes:
                    raise CheckpointError(
                        f"delta save of step {delta.step}: no retained "
                        f"snapshot for {r.tensor_name!r} — the chain "
                        f"tracker should have forced a keyframe")

    def save(self, directory, by_rank, objects, future, delta=None) -> None:
        plans: List[FilePlan] = []
        capture_items = []
        streamed_cb = None
        encode_budget = None
        all_records = [r for recs in by_rank.values() for r in recs]
        # registry routing resolves here, once per record: "auto" adapts to
        # the save mode, explicit routes pin a provider per state domain.
        resolved = {id(r): resolve_provider(r, delta) for r in all_records}
        delta_records = [r for r in all_records
                         if resolved[id(r)][0] == "delta"]
        if delta is None and delta_records:
            doms = sorted({r.domain for r in delta_records})
            raise CheckpointError(
                f"state domains {doms} are routed to the 'delta' provider "
                f"but the manager has no DeltaPolicy — set "
                f"CheckpointPolicy.delta, or route them to 'auto'/'tensor'")
        if delta is not None or any(
                resolved[id(r)][0] == "quantized"
                or resolved[id(r)][1] is not None  # custom: may encode too
                for r in all_records):
            # bounds in-flight freshly-allocated encoded (XOR / quantized /
            # custom) payloads between producer and flush lanes (~4 chunks'
            # worth, min 64 MiB)
            encode_budget = EncodeBudget(max(4 * self.chunk_bytes, 64 << 20))
        if delta is not None:
            self._await_delta_turn()
            self._delta_precheck(delta, delta_records, all_records)
            if delta.keyframe:
                # elastic reshard / re-route: drop snapshot entries for
                # tensors that left the delta set, then (re-)reserve it
                self.snapshot_cache.retain_only(
                    [r.tensor_name for r in delta_records])
            streamed = threading.Event()
            n_pending = [len(delta_records)]
            pend_lock = threading.Lock()
            if not delta_records:
                streamed.set()

            def streamed_cb() -> None:
                with pend_lock:
                    n_pending[0] -= 1
                    done = n_pending[0] == 0
                if done:
                    streamed.set()
        obj_rank = min(by_rank) if by_rank else 0
        save_domains: Dict[str, Dict[str, List[str]]] = {}
        file_domains: Dict[str, Dict[str, Any]] = {}
        for rank, records in sorted(by_rank.items()):
            provs: List[Any] = []
            domains_meta: Dict[str, Dict[str, List[str]]] = {}

            def note_domain(domain: str, provider: str, codec: str) -> None:
                e = domains_meta.setdefault(domain,
                                            {"providers": [], "codecs": []})
                if provider not in e["providers"]:
                    e["providers"].append(provider)
                if codec not in e["codecs"]:
                    e["codecs"].append(codec)

            for rec in records:
                kind, factory = resolved[id(rec)]
                kw = dict(
                    dtype=rec.dtype, shape=rec.shape, nbytes=rec.nbytes,
                    device=self.device,
                    host_array=None if rec.device_resident else rec.data,
                    global_shape=rec.global_shape, index=rec.index,
                    chunk_bytes=self.chunk_bytes,
                    stream_intra_tensor=self._stream_intra_tensor)
                if factory is not None:
                    tp = factory(rec, **kw)
                    if not isinstance(tp, TensorStateProvider):
                        raise CheckpointError(
                            f"custom provider factory {kind!r} returned "
                            f"{type(tp).__name__} for {rec.tensor_name!r}"
                            f" — factories must build TensorStateProvider "
                            f"subclasses")
                elif kind == "quantized":
                    tp = QuantizedStateProvider(rec.tensor_name, **kw)
                elif kind == "delta":
                    tp = DeltaStateProvider(
                        rec.tensor_name,
                        prev=self.snapshot_cache.ensure(rec.tensor_name,
                                                        rec.nbytes),
                        keyframe=delta.keyframe, codec=delta.codec, **kw)
                    tp.on_stream_end = streamed_cb
                else:
                    tp = TensorStateProvider(rec.tensor_name, **kw)
                # uniform encoded-provider wiring: defer encode work until
                # the device is drained (the staging lane runs uncontended,
                # so encoded saves add no capture latency over raw
                # snapshots) and bound in-flight payload allocations.
                if getattr(tp, "capture_gate", False) is None:
                    tp.capture_gate = future._captured
                if getattr(tp, "encode_budget", False) is None:
                    tp.encode_budget = encode_budget
                if self.checksum_files and hasattr(tp, "checksum_chunks"):
                    # fused encode emits per-chunk payload digests in the
                    # same pass; the footer stores them for verified decode
                    tp.checksum_chunks = True
                note_domain(rec.domain, kind,
                            "raw" if getattr(tp, "fixed_offset", True)
                            else getattr(tp, "enc_codec", "raw"))
                provs.append(tp)
                if rec.device_resident:
                    capture_items.append((tp, rec.data))
            if rank == obj_rank:
                provs.extend(self._object_providers(objects, future))
                for key in objects:
                    dom = _object_domain(key)
                    if dom is not None:
                        note_domain(dom, "object", "pickle")
            meta = {"rank": rank}
            if delta is not None:
                meta["delta"] = delta.manifest_meta()
            path = rank_file(directory, rank)
            if domains_meta:
                meta["domains"] = domains_meta
                merge_domains_meta(save_domains, domains_meta)
                file_domains[os.path.basename(path)] = domains_meta
            plans.append(FilePlan(path,
                                  CompositeStateProvider(f"rank{rank}", provs),
                                  meta=meta))
        if not by_rank:  # objects only
            provs = self._object_providers(objects, future)
            meta = {"rank": 0}
            if delta is not None:
                meta["delta"] = delta.manifest_meta()
            domains_meta = {}
            for key in objects:
                dom = _object_domain(key)
                if dom is not None:
                    domains_meta.setdefault(dom, {"providers": ["object"],
                                                  "codecs": ["pickle"]})
            path = rank_file(directory, 0)
            if domains_meta:
                meta["domains"] = domains_meta
                merge_domains_meta(save_domains, domains_meta)
                file_domains[os.path.basename(path)] = domains_meta
            plans.append(FilePlan(path,
                                  CompositeStateProvider("rank0", provs),
                                  meta=meta))
        if save_domains:
            # one derivation feeds the per-file footers (above), the
            # per-file FileEntry.domains catalog records (file_domains —
            # threaded to the committer so commit never has to re-parse
            # footers), and the step-level StepManifest.meta["domains"] —
            # all from the live provider instances (merged across rank
            # lanes by the coordinator).
            merge_domains_meta(
                future.stats.extra.setdefault("domains", {}), save_domains)
            future.stats.extra.setdefault("file_domains", {}).update(
                file_domains)
        self._engine.submit(plans, capture_items, future)
        if delta is not None:
            # Registered only now: a prologue failure above (cache full,
            # oversized payload) propagates to the caller without ever
            # settling `streamed`/the future — gating the next save on it
            # would stall the retry for the full gate timeout. Nothing has
            # streamed before submit succeeds, so there is nothing to
            # order against on those paths.
            self._delta_prev = (streamed, future)

    def drain(self) -> None:
        self._engine.drain()

    def close(self) -> None:
        self._engine.close()


class DataStatesOldEngine(DataStatesEngine):
    """HPDC'24 engine: lazy capture + async flush, but blocking up-front
    object serialization and tensor-granular (non-streamed) staging."""

    name = "datastates-old"
    _stream_intra_tensor = False
    _blocking_object_serialization = True


# --------------------------------------------------------------------------
class SnapshotThenFlushEngine(BaseCheckpointEngine):
    """TorchSnapshot-style: blocking snapshot of everything, then async
    multi-threaded chunk-file flush (one *file per chunk*)."""

    name = "snapshot"

    CHUNK_FILE_BYTES = 64 << 20

    def __init__(self, **kw):
        super().__init__(**kw)
        self._q: "queue.Queue[Optional[tuple]]" = queue.Queue()
        self._threads = [threading.Thread(target=self._worker, daemon=True,
                                          name=f"snapshot-flush-{i}")
                         for i in range(self.flush_threads)]
        for t in self._threads:
            t.start()

    def save(self, directory, by_rank, objects, future, delta=None) -> None:
        if delta is not None:
            raise ValueError(
                "differential checkpointing requires a DataMovementEngine "
                "mode; the snapshot baseline cannot encode deltas")
        _reject_encoded_routes(by_rank, self.name)
        stats = future.stats
        # (1) blocking: metadata/object serialization first (precompute the
        # layout manifest up front — §IV-D's "do the opposite" pattern).
        t0 = time.perf_counter()
        obj_payload = pickle.dumps(objects, protocol=pickle.HIGHEST_PROTOCOL)
        stats.serialize_s += time.perf_counter() - t0
        stats.bytes_objects += len(obj_payload)

        # (2) blocking D2H snapshot: fresh (pageable) allocations each time.
        t0 = time.perf_counter()
        snapshots: Dict[int, List[tuple]] = {}
        for rank, records in sorted(by_rank.items()):
            for rec in records:
                flat = _host_array(rec.data).reshape(-1).view(np.uint8)
                snapshots.setdefault(rank, []).append((rec, flat))
                stats.bytes_tensors += rec.nbytes
                stats.n_tensors += 1
        stats.stage_s += time.perf_counter() - t0
        future._set_captured()

        # (3) async: chunk-file writes + per-rank manifest.
        pending = {"n": 0}
        lock = threading.Lock()

        def done_one():
            with lock:
                pending["n"] -= 1
                last = pending["n"] == 0
            if last:
                future._set_persisted()

        jobs = []
        for rank, snaps in snapshots.items():
            manifest = {"tensors": [], "objects": None}
            for rec, flat in snaps:
                n_chunks = max(1, -(-rec.nbytes // self.CHUNK_FILE_BYTES))
                chunk_paths = []
                for ci in range(n_chunks):
                    lo = ci * self.CHUNK_FILE_BYTES
                    hi = min(lo + self.CHUNK_FILE_BYTES, rec.nbytes)
                    safe = rec.tensor_name.replace("/", "_").replace("@", "_")
                    cpath = os.path.join(
                        directory, f"r{rank:03d}_{safe}_c{ci:04d}.bin")
                    chunk_paths.append((cpath, lo, hi))
                    jobs.append((cpath, flat[lo:hi], future))
                manifest["tensors"].append({
                    "name": rec.tensor_name, "dtype": rec.dtype,
                    "shape": rec.shape, "global_shape": rec.global_shape,
                    "index": rec.index,
                    "chunks": [(p, lo, hi) for p, lo, hi in chunk_paths]})
            mpath = os.path.join(directory, f"manifest_rank{rank:05d}.pkl")
            payload = pickle.dumps(manifest)
            jobs.append((mpath, payload, future))
        if min(by_rank, default=0) in snapshots or not by_rank:
            opath = os.path.join(directory, "objects.pkl")
            jobs.append((opath, obj_payload, future))
        # one job == one file (chunk files + manifests + objects.pkl)
        stats.n_files = len(jobs)
        with lock:
            pending["n"] = len(jobs)
        if not jobs:
            future._set_persisted()
        for path, data, fut in jobs:
            self._q.put((path, data, fut, done_one))

    def _worker(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            path, data, future, done_one = item
            try:
                t0 = time.perf_counter()
                with open(path, "wb") as f:
                    f.write(data)
                    f.flush()
                    maybe_fsync(f.fileno())
                nb = len(data) if isinstance(data, bytes) else data.nbytes
                self._throttle(nb, t0)
                future.stats.flush_s += time.perf_counter() - t0
                done_one()
            except BaseException as exc:  # noqa: BLE001
                future._set_error(exc)
            finally:
                self._q.task_done()

    def drain(self) -> None:
        self._q.join()

    def close(self) -> None:
        for _ in self._threads:
            self._q.put(None)
        join_lanes(self._threads)


# --------------------------------------------------------------------------
class SyncSerializedEngine(BaseCheckpointEngine):
    """DeepSpeed-default / torch.save analogue: fully blocking, type-agnostic
    serialization of the whole object graph (tensor payloads copied to the
    host and through the pickler), single synchronous write per rank file.
    The graph is the JAX package's: each leaf a numpy array, bfloat16 as
    an ``ml_dtypes.bfloat16`` array (:mod:`~.pickle_compat`)."""

    name = "sync"

    def save(self, directory, by_rank, objects, future, delta=None) -> None:
        if delta is not None:
            raise ValueError(
                "differential checkpointing requires a DataMovementEngine "
                "mode; the sync baseline cannot encode deltas")
        _reject_encoded_routes(by_rank, self.name)
        stats = future.stats
        obj_rank = min(by_rank) if by_rank else 0
        ranks = sorted(by_rank) if by_rank else [0]
        for rank in ranks:
            records = by_rank.get(rank, [])
            t0 = time.perf_counter()
            graph: Dict[str, Any] = {}
            for rec in records:
                # device-to-host copy + deep copy through the pickler
                graph[rec.tensor_name] = {
                    "data": _host_array(rec.data), "dtype": rec.dtype,
                    "shape": rec.shape, "global_shape": rec.global_shape,
                    "index": rec.index}
                stats.bytes_tensors += rec.nbytes
                stats.n_tensors += 1
            if rank == obj_rank:
                graph["__objects__"] = objects
            payload = pickle_compat.dumps(graph)
            del graph
            stats.serialize_s += time.perf_counter() - t0
            t0 = time.perf_counter()
            # One blocking whole-graph write (torch.save analogue), made
            # through the repository's atomic helper: a crash leaves no
            # partial rank pickle, and the rename costs nothing beside
            # the write and its fsync.
            atomic_write(rank_file(directory, rank, ext="pkl"), payload,
                         fsync=maybe_fsync)
            self._throttle(len(payload), t0)
            stats.flush_s += time.perf_counter() - t0
            stats.n_files += 1
        future._set_captured()
        future._set_persisted()


# --------------------------------------------------------------------------
# Loaders for the non-native baseline formats (used by tests/benchmarks).

def load_sync_rank(path: str) -> Dict[str, Any]:
    """One rank's pickled graph, of either package: each leaf's
    ``"data"`` a numpy array, bfloat16 as :data:`~.dtypes.BF16_HOST`."""
    with open(path, "rb") as f:
        return pickle_compat.load(f)


def load_snapshot_rank(directory: str, rank: int
                       ) -> Dict[str, torch.Tensor]:
    """One rank's tensors of a snapshot step, of either package, as CPU
    tensors (numpy has no bfloat16 without ``ml_dtypes``)."""
    mpath = os.path.join(directory, f"manifest_rank{rank:05d}.pkl")
    with open(mpath, "rb") as f:
        manifest = pickle_compat.load(f)
    out = {}
    for t in manifest["tensors"]:
        dt = dtypes.lookup(t["dtype"])
        nbytes = int(np.prod(t["shape"], dtype=np.int64)) * dt.itemsize \
            if t["shape"] else dt.itemsize
        buf = np.empty(nbytes, dtype=np.uint8)
        for cpath, lo, hi in t["chunks"]:
            with open(cpath, "rb") as f:
                buf[lo:hi] = np.frombuffer(f.read(), dtype=np.uint8)
        out[t["name"]] = dtypes.host_to_tensor(
            buf.view(dt.storage).reshape(t["shape"]), t["dtype"], "cpu")
    return out
