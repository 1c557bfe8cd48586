"""Parallel streaming restore engine (the save path's twin).

1. **Index once** — every ``.dsllm`` file in the step directory is opened
   exactly once and its shard directory (name, global region, byte layout)
   is extracted from the footer.
2. **Plan up front** — for every template leaf the target region is
   intersected with the stored shard regions, producing an explicit list
   of byte ranges *before* any data is read. Coverage is validated at plan
   time.
3. **Fan out ranged reads** — the byte ranges become positional
   ``os.preadv`` calls over a thread pool, reading only intersecting bytes
   directly into preallocated host buffers.
4. **Assemble** — each tensor leaf is built on its *template leaf's
   device* (a CUDA template gets a CUDA tensor); numpy leaves stay numpy.
   A :class:`~repro_torch.sharding.ShardedTensor` template is planned as
   one target region per unique shard of its own mesh and spec, and
   assembled as a sharded tensor on that mesh — so a step written by N
   ranks on one layout restores onto any other layout and world (elastic
   re-sharding, chain steps too). A ``DTensor`` template (one rank of a
   ``torch.distributed`` group) is planned as this rank's region alone
   and assembled with ``DTensor.from_local``: each rank reads its own
   bytes.

Differential steps replay as a chain (:meth:`RestoreEngine.restore_chain`):
the keyframe restores like a full snapshot, then each delta step's payloads
are decompressed, digest-verified and XOR-folded into the host buffers on
the engine's device (the ``delta_xor`` kernel on a card).

Self-contained encoded tensors (int8-quantized optimizer state) restore
like raw ones: decoded once per restore on the engine's device (the
dequantize kernel on a card, digest-verified), in plain, chain and
selective ``domains=`` restores alike.

Every engine's format restores (native ``.dsllm``, the snapshot engine's
chunk files under per-rank manifests, the sync engine's pickled graphs;
:mod:`~.pickle_compat` reads the JAX package's bfloat16 leaves), so a run
can switch engines between save and resume. A template dtype other than
the stored one casts values as the JAX package does
(:func:`~.dtypes.cast_host`). ``throttle_mbps`` emulates per-stream
storage bandwidth on the reads, as the save-side engines do.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import glob
import itertools
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.ops import lane_stream
from repro_torch.obs import trace as obs
from repro_torch.sharding.context import is_dtensor
from repro_torch.sharding.sharded import ShardedTensor

from . import dtypes, pickle_compat
from .codecs import is_chained_codec
from .distributed import normalize_index
from .layout import FileReader
from .tree import flatten_with_path, path_str

Region = Tuple[Tuple[int, int], ...]  # ((start, stop), ...) per dim


class RestoreError(RuntimeError):
    """A checkpoint could not be indexed or did not cover a request."""


@dataclasses.dataclass
class RestoreStats:
    """Phase timings + I/O accounting for one restore."""

    index_s: float = 0.0      # footer/manifest indexing
    plan_s: float = 0.0       # intersection planning
    read_s: float = 0.0       # parallel ranged-read fan-out (wall clock)
    fold_s: float = 0.0       # delta payloads: decompress, digest, XOR fold
    verify_s: float = 0.0     # chain members' checksums re-read first
    assemble_s: float = 0.0   # host buffers -> tensors on their device
    bytes_read: int = 0       # bytes actually fetched from storage
    n_ranges: int = 0         # ranged reads issued
    n_files: int = 0          # checkpoint files indexed
    n_leaves: int = 0         # template leaves restored
    threads: int = 0          # fan-out width used

    @property
    def total_s(self) -> float:
        return self.index_s + self.plan_s + self.read_s + self.fold_s \
            + self.verify_s + self.assemble_s


# --------------------------------------------------------------------------
# Byte-range math for C-contiguous stored shards.

def _volume(region: Region) -> int:
    v = 1
    for lo, hi in region:
        v *= max(0, hi - lo)
    return v


def _contiguous_runs(local_region: Region, shape: Tuple[int, ...],
                     itemsize: int):
    """Yield ``(byte_offset, nbytes)`` contiguous runs of ``local_region``
    within a C-contiguous array of ``shape``, in C order.

    Runs are maximal: a suffix of dims fully covered by the region folds
    into its predecessor, so a full-array region is a single run.
    """
    nd = len(shape)
    if nd == 0:
        yield 0, itemsize
        return
    if any(hi <= lo for lo, hi in local_region):
        return
    k = nd
    while k > 0 and local_region[k - 1] == (0, shape[k - 1]):
        k -= 1
    inner = itemsize
    for d in range(k, nd):
        inner *= shape[d]
    if k == 0:
        yield 0, inner
        return
    run_lo, run_hi = local_region[k - 1]
    run_bytes = (run_hi - run_lo) * inner
    # byte strides of the outer (partially covered) dims 0..k-2
    strides = [0] * (k - 1)
    acc = inner * shape[k - 1]
    for d in range(k - 2, -1, -1):
        strides[d] = acc
        acc *= shape[d]
    base = run_lo * inner
    for coords in itertools.product(
            *[range(lo, hi) for lo, hi in local_region[:k - 1]]):
        yield base + sum(c * strides[d] for d, c in enumerate(coords)), \
            run_bytes


def plan_ranged_slices(nbytes: int, slice_bytes: int = 16 << 20
                       ) -> List[Tuple[int, int]]:
    """``[(offset, nbytes), ...]`` fixed-cap slices covering ``[0, nbytes)``.

    The ranged-read splitting discipline shared by the restore engine
    (``_emit_tasks`` splits giant runs so they parallelize across the
    thread pool) and the fleet's peer exchange (which deals the same
    disjoint slices to concurrent replicas so each remote byte is read by
    exactly one of them)."""
    cap = max(1, int(slice_bytes))
    return [(lo, min(cap, nbytes - lo)) for lo in range(0, nbytes, cap)]


#: runs of one file at most this far apart are read as one span and
#: copied out: a shard's rows cut by another layout's columns take one
#: read a block of rows, not one a row (each read is a syscall and a turn
#: of the GIL; a 2 KB run a row made an elastic restore of llama3.2-1b's
#: optimizer state take minutes)
COALESCE_GAP_BYTES = 1 << 20

Read = Tuple[str, int, int, int]  # (path, file offset, nbytes, dst offset)


def _spans(reads: List[Read], cap: int) -> List[List[Read]]:
    """Consecutive reads of one file whose gaps are at most
    :data:`COALESCE_GAP_BYTES`, grouped into spans of at most ``cap``
    bytes (a read of ``cap`` or more stays alone)."""
    groups: List[List[Read]] = []
    for r in reads:
        g = groups[-1] if groups else None
        if g is not None and r[0] == g[0][0] \
                and 0 <= r[1] - (g[-1][1] + g[-1][2]) <= COALESCE_GAP_BYTES \
                and r[1] + r[2] - g[0][1] <= cap:
            g.append(r)
        else:
            groups.append([r])
    return groups


def _read_span(fd: int, group: List[Read], out: np.ndarray) -> int:
    """Fill ``out`` (flat uint8) at each read's destination from one read
    of the group's span; returns the bytes the group asked for (the gaps
    the span also reads are not counted, so ``bytes_read``, ``n_ranges``
    and the throttle stay the reference's, read by read)."""
    start = group[0][1]
    end = group[-1][1] + group[-1][2]
    if len(group) == 1:
        _p, off, nb, dst = group[0]
        _preadv_full(fd, memoryview(out[dst:dst + nb]), off)
        return nb
    span = np.empty(end - start, np.uint8)
    _preadv_full(fd, memoryview(span), start)
    offs = np.array([r[1] for r in group], np.int64) - start
    nbs = np.array([r[2] for r in group], np.int64)
    dsts = np.array([r[3] for r in group], np.int64)
    d_off, d_dst = np.diff(offs), np.diff(dsts)
    if (nbs == nbs[0]).all() and (d_off == d_off[0]).all() \
            and (d_dst == d_dst[0]).all():
        # rows of equal runs at equal strides (a column cut): one copy
        as_strided = np.lib.stride_tricks.as_strided
        k, nb = len(group), int(nbs[0])
        src = as_strided(span[offs[0]:], (k, nb), (int(d_off[0]), 1))
        dst = as_strided(out[dsts[0]:], (k, nb), (int(d_dst[0]), 1))
        dst[...] = src
    else:
        for off, nb, dst_at in zip(offs, nbs, dsts):
            out[dst_at:dst_at + nb] = span[off:off + nb]
    return int(nbs.sum())


def _preadv_full(fd: int, mv: memoryview, offset: int) -> None:
    pos = 0
    end = len(mv)
    while pos < end:
        n = os.preadv(fd, [mv[pos:]], offset + pos)
        if n <= 0:
            raise RestoreError(
                f"short read at offset {offset + pos} (wanted {end - pos} "
                f"more bytes) — truncated checkpoint file?")
        pos += n


class _FDCache:
    """Positional-read fd per file, shared across reader threads."""

    def __init__(self) -> None:
        self._fds: Dict[str, int] = {}
        self._lock = threading.Lock()

    def get(self, path: str) -> int:
        with self._lock:
            fd = self._fds.get(path)
            if fd is None:
                fd = os.open(path, os.O_RDONLY)
                self._fds[path] = fd
            return fd

    def close(self) -> None:
        with self._lock:
            for fd in self._fds.values():
                os.close(fd)
            self._fds.clear()


# --------------------------------------------------------------------------
# Shard sources: one stored shard of a logical array, format-specific.

class _ShardSource:
    """Base: a stored shard covering ``index`` of the global array."""

    __slots__ = ("index", "shape", "dtype_name", "dtype")

    def __init__(self, index: Region, shape: Tuple[int, ...], dtype: str):
        self.index = tuple(tuple(p) for p in index)
        self.shape = tuple(shape)
        self.dtype_name = dtype
        self.dtype = dtypes.lookup(dtype).storage

    def byte_ranges(self, local_region: Region):
        """(file_path, file_offset, nbytes) pieces for ``local_region``,
        in C order of the region. None for non-byte-addressable formats."""
        raise NotImplementedError

    def read_fallback(self, local_region: Region) -> np.ndarray:
        """Materialize ``local_region`` without ranged reads."""
        raise NotImplementedError


class _DsllmShard(_ShardSource):
    """Fixed-offset aligned tensor region in a native ``.dsllm`` file."""

    __slots__ = ("path", "offset")

    def __init__(self, path: str, entry):
        index = entry.index if entry.index is not None \
            else tuple((0, d) for d in entry.shape)
        super().__init__(index, entry.shape, entry.dtype)
        self.path = path
        self.offset = entry.offset

    def byte_ranges(self, local_region: Region):
        for off, nb in _contiguous_runs(local_region, self.shape,
                                        self.dtype.itemsize):
            yield self.path, self.offset + off, nb


class _SnapshotShard(_ShardSource):
    """One tensor spread over TorchSnapshot-style chunk files."""

    __slots__ = ("chunks",)

    def __init__(self, index: Region, shape, dtype: str,
                 chunks: Sequence[Tuple[str, int, int]]):
        super().__init__(index, shape, dtype)
        # (path, lo, hi): byte interval of the flattened tensor per file
        self.chunks = sorted(chunks, key=lambda c: c[1])

    def byte_ranges(self, local_region: Region):
        for off, nb in _contiguous_runs(local_region, self.shape,
                                        self.dtype.itemsize):
            run_lo, run_hi = off, off + nb
            for path, lo, hi in self.chunks:
                a, b = max(run_lo, lo), min(run_hi, hi)
                if a < b:
                    yield path, a - lo, b - a


class _EncodedShard(_ShardSource):
    """A self-contained encoded tensor (e.g. an int8-quantized optimizer
    moment) in a native file: its compressed log chunks decode without a
    chain base, so it restores standalone — decoded at most once per
    restore (thread-safe), then sliced in memory."""

    __slots__ = ("loader",)

    def __init__(self, index: Region, shape, dtype,
                 loader: Callable[[], np.ndarray]):
        super().__init__(index, shape, dtype)
        self.loader = loader

    def byte_ranges(self, local_region: Region):
        return None

    def read_fallback(self, local_region: Region) -> np.ndarray:
        arr = self.loader()
        return arr[tuple(slice(lo, hi) for lo, hi in local_region)]


class _GraphShard(_ShardSource):
    """A shard inside a pickled object graph (sync format): the graph is
    loaded at most once per restore; slicing happens in memory."""

    __slots__ = ("loader", "name")

    def __init__(self, index: Region, shape, dtype: str,
                 loader: Callable[[], Dict[str, Any]], name: str):
        super().__init__(index, shape, dtype)
        self.loader = loader
        self.name = name

    def byte_ranges(self, local_region: Region):
        return None

    def read_fallback(self, local_region: Region) -> np.ndarray:
        arr = np.asarray(self.loader()[self.name]["data"])
        return arr[tuple(slice(lo, hi) for lo, hi in local_region)]


class _OnceLoader:
    """Thread-safe load-once wrapper around an expensive whole-file read."""

    def __init__(self, fn: Callable[[], Any], nbytes: int,
                 stats: "RestoreStats", stats_lock: threading.Lock):
        self._fn = fn
        self._nbytes = nbytes
        self._stats = stats
        self._stats_lock = stats_lock
        self._lock = threading.Lock()
        self._value: Any = None
        self._loaded = False

    def __call__(self) -> Any:
        with self._lock:
            if not self._loaded:
                self._value = self._fn()
                self._loaded = True
                with self._stats_lock:
                    self._stats.bytes_read += self._nbytes
                    self._stats.n_ranges += 1
        return self._value


# --------------------------------------------------------------------------

class RestoreIndex:
    """Everything learned from one pass over a step directory."""

    def __init__(self, sdir: str):
        self.sdir = sdir
        self.tensors: Dict[str, List[_ShardSource]] = {}
        # Differential steps: encoded (XOR-domain) shards, keyed like
        # ``tensors`` but holding ``(FileReader, TensorEntry)`` pairs —
        # their payloads are compressed log chunks, not byte-addressable
        # regions, and their values only exist relative to a chain base.
        self.delta_tensors: Dict[str, List[Tuple[Any, Any]]] = {}
        self.objects: Dict[str, Callable[[], Any]] = {}
        self.n_files = 0


class _Run:
    """Per-restore mutable state, so one engine instance (e.g. the manager's
    default) can serve concurrent restores without sharing fd caches."""

    __slots__ = ("stats", "lock", "fds", "flow")

    def __init__(self, stats: RestoreStats):
        self.stats = stats
        self.lock = threading.Lock()
        self.fds = _FDCache()
        # flow-link id tying this restore's index→plan→read→assemble spans
        self.flow = obs.flow_id("restore", id(self) & 0xFFFFFF)


def _leaf_dtype_name(leaf) -> str:
    if isinstance(leaf, (torch.Tensor, ShardedTensor)):
        return dtypes.BY_TORCH[leaf.dtype].name
    return dtypes.of_array(leaf).name


class RestoreEngine:
    """Plans and executes parallel ranged restores from any engine format.

    ``device`` runs the chain replay's digest checks and XOR folds and
    the int8 decodes.
    ``threads`` is the ranged-read fan-out width (``1`` gives a serial
    engine with identical results). ``throttle_mbps`` emulates per-stream
    storage bandwidth exactly like the save-side engines do.
    ``read_chunk_bytes`` caps a single ``preadv`` so large tensors split
    across the pool instead of serializing behind one thread.
    """

    def __init__(self, device: torch.device, threads: Optional[int] = None,
                 throttle_mbps: Optional[float] = None,
                 read_chunk_bytes: int = 16 << 20):
        # where delta payload digests are verified and XOR folds run
        self.device = torch.device(device)
        if threads is None:
            threads = min(16, 4 * (os.cpu_count() or 1))
        self.threads = max(1, int(threads))
        self.throttle_mbps = throttle_mbps
        self.read_chunk_bytes = int(read_chunk_bytes)

    def _throttle(self, nbytes: int, t0: float) -> None:
        """Emulate per-stream storage bandwidth: a read of ``nbytes``
        begun at ``t0`` ends no sooner than ``nbytes / throttle_mbps``."""
        if self.throttle_mbps and nbytes:
            target = nbytes / (self.throttle_mbps * 1e6)
            elapsed = time.perf_counter() - t0
            if target > elapsed:
                time.sleep(target - elapsed)

    # ------------------------------------------------------------- indexing
    def index(self, sdir: str, stats: Optional[RestoreStats] = None,
              stats_lock: Optional[threading.Lock] = None) -> RestoreIndex:
        """One pass over ``sdir``: build the shard directory for whatever
        checkpoint format lives there (same precedence as the writers:
        native ``.dsllm``, then snapshot manifests, then sync pickles)."""
        stats = stats if stats is not None else RestoreStats()
        stats_lock = stats_lock or threading.Lock()
        idx = RestoreIndex(sdir)
        dsllm = sorted(glob.glob(os.path.join(sdir, "*.dsllm")))
        if dsllm:
            self._index_dsllm(idx, dsllm, stats, stats_lock)
            return idx
        manifests = sorted(glob.glob(os.path.join(sdir,
                                                  "manifest_rank*.pkl")))
        snapshot_objects = os.path.join(sdir, "objects.pkl")
        if manifests or os.path.exists(snapshot_objects):
            self._index_snapshot(idx, manifests, snapshot_objects, stats,
                                 stats_lock)
            return idx
        pkls = sorted(glob.glob(os.path.join(sdir, "*.pkl")))
        if pkls:
            self._index_sync(idx, pkls, stats, stats_lock)
            return idx
        raise FileNotFoundError(f"no checkpoint files in {sdir}")

    def _index_dsllm(self, idx: RestoreIndex, dsllm: List[str],
                     stats: RestoreStats,
                     stats_lock: threading.Lock) -> None:
        for p in dsllm:
            try:
                rd = FileReader(p)
            except (OSError, ValueError, KeyError, TypeError) as exc:
                raise RestoreError(
                    f"corrupt or truncated checkpoint file {p!r}: {exc} "
                    f"(footer unreadable — was the save interrupted?)"
                ) from exc
            idx.n_files += 1
            for entry in rd.tensors.values():
                base = entry.name.split("@[", 1)[0]
                if entry.codec != "raw" and is_chained_codec(entry.codec):
                    idx.delta_tensors.setdefault(base, []).append(
                        (rd, entry))
                elif entry.codec != "raw":
                    # self-contained encoding (quantized): restorable
                    # standalone through a decode-once shard source
                    region = entry.index if entry.index is not None \
                        else tuple((0, d) for d in entry.shape)
                    comp_nb = sum(c[1] for c in entry.enc_chunks or ())
                    loader = _OnceLoader(
                        (lambda r=rd, e=entry: dtypes.host_view(
                            r.read_encoded_tensor(e.name, self.device),
                            e.dtype).reshape(e.shape)),
                        comp_nb, stats, stats_lock)
                    idx.tensors.setdefault(base, []).append(
                        _EncodedShard(tuple(map(tuple, region)),
                                      entry.shape, entry.dtype, loader))
                else:
                    idx.tensors.setdefault(base, []).append(
                        _DsllmShard(p, entry))
            for oname, oe in rd.objects.items():
                idx.objects[oname] = _OnceLoader(
                    (lambda r=rd, n=oname: r.read_object(n)),
                    oe.nbytes, stats, stats_lock)

    @staticmethod
    def _index_snapshot(idx: RestoreIndex, manifests: List[str],
                        snapshot_objects: str, stats: RestoreStats,
                        stats_lock: threading.Lock) -> None:
        sdir = idx.sdir
        for mpath in manifests:
            try:
                with open(mpath, "rb") as f:
                    manifest = pickle_compat.load(f)
            except Exception as exc:
                raise RestoreError(
                    f"corrupt or truncated manifest {mpath!r}: {exc}"
                ) from exc
            idx.n_files += 1
            for t in manifest["tensors"]:
                base = t["name"].split("@[", 1)[0]
                chunks = []
                for cpath, lo, hi in t["chunks"]:
                    if not os.path.exists(cpath):  # step dir was moved
                        cpath = os.path.join(sdir, os.path.basename(cpath))
                    chunks.append((cpath, lo, hi))
                    idx.n_files += 1
                index = t["index"] if t["index"] is not None \
                    else tuple((0, d) for d in t["shape"])
                idx.tensors.setdefault(base, []).append(_SnapshotShard(
                    tuple(map(tuple, index)), t["shape"], t["dtype"],
                    chunks))
        if os.path.exists(snapshot_objects):
            idx.n_files += 1
            nb = os.path.getsize(snapshot_objects)
            try:
                with open(snapshot_objects, "rb") as f:
                    objs = pickle_compat.load(f)
            except Exception as exc:
                raise RestoreError(
                    f"corrupt or truncated object file "
                    f"{snapshot_objects!r}: {exc}") from exc
            with stats_lock:
                stats.bytes_read += nb
                stats.n_ranges += 1
            for oname, val in objs.items():
                idx.objects[oname] = (lambda v=val: v)

    @staticmethod
    def _index_sync(idx: RestoreIndex, pkls: List[str],
                    stats: RestoreStats,
                    stats_lock: threading.Lock) -> None:
        for p in pkls:
            try:
                with open(p, "rb") as f:
                    graph = pickle_compat.load(f)
            except Exception as exc:
                raise RestoreError(
                    f"corrupt or truncated checkpoint file {p!r}: {exc}"
                ) from exc
            nb = os.path.getsize(p)
            idx.n_files += 1
            # count the (unavoidable) whole-graph load once, at index
            # time — the graph is then sliced in memory, never re-read.
            with stats_lock:
                stats.bytes_read += nb
                stats.n_ranges += 1
            loader = (lambda g=graph: g)
            for name, rec in graph.items():
                if name == "__objects__":
                    for oname, val in rec.items():
                        idx.objects[oname] = (lambda v=val: v)
                    continue
                base = name.split("@[", 1)[0]
                arr = np.asarray(rec["data"])
                index = rec["index"] if rec["index"] is not None \
                    else tuple((0, d) for d in arr.shape)
                idx.tensors.setdefault(base, []).append(_GraphShard(
                    tuple(map(tuple, index)), arr.shape,
                    dtypes.host_name(arr), loader, name))

    # ------------------------------------------------------------- planning
    @staticmethod
    def _leaf_regions(leaf) -> Tuple[List[Region], str]:
        """Target regions for one template leaf: one per unique shard of
        a sharded template's layout (elastic), or the full array (a torch
        tensor or numpy array lives whole on one device)."""
        shape = tuple(leaf.shape)
        full = tuple((0, d) for d in shape)
        if is_dtensor(leaf):  # this rank's own region only
            from repro_torch.sharding.partition import local_index
            return [normalize_index(local_index(leaf), shape)], "dtensor"
        if isinstance(leaf, ShardedTensor):
            regions: List[Region] = []
            for index in leaf.devices_indices_map().values():
                region = normalize_index(index, shape)
                if region not in regions:
                    regions.append(region)
            return regions or [full], "sharded"
        return [full], "torch" if isinstance(leaf, torch.Tensor) else "numpy"

    def _plan_region(self, run: _Run, sources: List[_ShardSource],
                     region: Region, buf: np.ndarray,
                     tasks: List[Callable[[], Tuple[int, int]]],
                     leaf_name: str, dtype_name: str) -> None:
        """Intersect ``region`` with the stored shards; append read tasks
        that fill ``buf`` (shaped like ``region``, storage of
        ``dtype_name``) in place."""
        covered = 0
        for src in sources:
            inter = tuple((max(a, c), min(b, d))
                          for (a, b), (c, d) in zip(region, src.index))
            if any(lo >= hi for lo, hi in inter):
                continue
            covered += _volume(inter)
            src_local = tuple((lo - c, hi - c)
                              for (lo, hi), (c, _d) in zip(inter, src.index))
            dst_sl = tuple(slice(lo - a, hi - a)
                           for (lo, hi), (a, _b) in zip(inter, region))
            dst_view = buf[dst_sl] if dst_sl else buf[...]
            self._emit_tasks(run, src, src_local, dst_view, dtype_name,
                             tasks)
        if covered < _volume(region):
            raise RestoreError(
                f"checkpoint does not cover requested region {region} of "
                f"{leaf_name!r} (stored shards cover {covered} of "
                f"{_volume(region)} elements — wrong template shape, or a "
                f"partially written checkpoint?)")

    def _emit_tasks(self, run: _Run, src: _ShardSource, src_local: Region,
                    dst_view: np.ndarray, dtype_name: str,
                    tasks: List[Callable[[], Tuple[int, int]]]) -> None:
        ranges = src.byte_ranges(src_local)
        if ranges is None or src.dtype_name != dtype_name \
                or not dst_view.flags["C_CONTIGUOUS"]:
            # Non-byte-addressable source (decoded or a pickled graph), a
            # dtype-converting restore (template dtype != stored dtype —
            # raw bytes must not land in the destination; values are cast
            # as the JAX package casts them), or a destination view whose
            # memory layout differs from the C order of the ranges (a
            # stored shard covering part of the leaf): read through a
            # scratch intersection buffer.
            def copy_task(src=src, src_local=src_local, dst_view=dst_view):
                arr = self._read_intersection(run, src, src_local)
                dst_view[...] = dtypes.cast_host(arr, src.dtype_name,
                                                 dtype_name)
                return 0, 0  # byte accounting happens inside the source
            tasks.append(copy_task)
            return
        out = dst_view.reshape(-1).view(np.uint8)
        reads: List[Read] = []
        pos = 0
        for path, off, nb in ranges:
            # split giant runs so they parallelize
            for lo, piece in plan_ranged_slices(nb, self.read_chunk_bytes):
                reads.append((path, off + lo, piece, pos + lo))
            pos += nb
        for group in _spans(reads, self.read_chunk_bytes):
            tasks.append(self._make_pread_task(run, group, out))

    def _make_pread_task(self, run: _Run, group: List[Read],
                         out: np.ndarray) -> Callable[[], Tuple[int, int]]:
        def task():
            t0 = time.perf_counter()
            n = _read_span(run.fds.get(group[0][0]), group, out)
            self._throttle(n, t0)
            return n, len(group)
        return task

    def _read_intersection(self, run: _Run, src: _ShardSource,
                           src_local: Region) -> np.ndarray:
        """Scratch-buffer path: ``src_local`` of ``src`` in its stored
        dtype, by ranged reads where the source has them."""
        shape = tuple(hi - lo for lo, hi in src_local)
        ranges = src.byte_ranges(src_local)
        if ranges is None:
            return src.read_fallback(src_local)
        tmp = np.empty(shape, dtype=src.dtype)
        out = tmp.reshape(-1).view(np.uint8)
        reads: List[Read] = []
        pos = 0
        for path, off, nb in ranges:
            reads.append((path, off, nb, pos))
            pos += nb
        t0 = time.perf_counter()
        groups = _spans(reads, self.read_chunk_bytes)
        n = sum(_read_span(run.fds.get(g[0][0]), g, out) for g in groups)
        with run.lock:
            run.stats.bytes_read += n
            run.stats.n_ranges += len(reads)
        self._throttle(n, t0)
        return tmp

    # ------------------------------------------------------------- restore
    def _run_tasks(self, run: _Run,
                   tasks: List[Callable[[], Tuple[int, int]]],
                   phase: str = "read") -> None:
        """Fan the read/apply tasks over the pool; fold I/O accounting and
        the wall time into ``stats.read_s`` or ``stats.fold_s``."""
        stats = run.stats
        t0 = time.perf_counter()

        def in_lane(task):
            # digest checks and XOR folds run on a stream of their own,
            # off the stream of the caller's device work
            with lane_stream(self.device):
                return task()

        def account(nb: int, nr: int) -> None:
            # the sources' loaders count under the same lock
            with run.lock:
                stats.bytes_read += nb
                stats.n_ranges += nr
        if tasks:
            if self.threads == 1:
                for t in tasks:
                    account(*in_lane(t))
            else:
                with concurrent.futures.ThreadPoolExecutor(
                        self.threads) as pool:
                    for nb, nr in pool.map(in_lane, tasks):
                        account(nb, nr)
        t1 = time.perf_counter()
        setattr(stats, f"{phase}_s", getattr(stats, f"{phase}_s") + t1 - t0)
        if tasks:
            obs.add_span(f"restore.{phase}", t0, t1, tasks=len(tasks),
                         flow=run.flow)

    def _read_step(self, run: _Run, sdir: str, template: Any):
        """Index ``sdir``, plan per-leaf regions/buffers, execute the
        ranged-read fan-out. Returns ``(treedef, assembled, idx)`` with
        the host buffers filled but not yet assembled into leaves."""
        stats = run.stats
        t0 = time.perf_counter()
        idx = self.index(sdir, stats, run.lock)
        t1 = time.perf_counter()
        stats.index_s += t1 - t0
        obs.add_span("restore.index", t0, t1, dir=os.path.basename(sdir),
                     flow=run.flow, flow_phase="start")
        stats.n_files += idx.n_files

        # ---- plan: regions, buffers, and the full read-task list
        t0 = time.perf_counter()
        leaves, treedef = flatten_with_path(template)
        tasks: List[Callable[[], Tuple[int, int]]] = []
        # (kind, leaf, aux, pstr) per template leaf
        assembled: List[Tuple[str, Any, Any, str]] = []
        for path, leaf in leaves:
            pstr = f"state/{path_str(path)}"
            if isinstance(leaf, (torch.Tensor, ShardedTensor, np.ndarray)):
                if pstr not in idx.tensors:
                    if pstr in idx.delta_tensors:
                        raise RestoreError(
                            f"tensor {pstr!r} is delta-encoded in {sdir!r} "
                            f"— a differential step cannot be restored "
                            f"alone; replay its chain (restore_chain / "
                            f"CheckpointManager.restore)")
                    raise KeyError(
                        f"tensor {pstr!r} not found in checkpoint "
                        f"(have {sorted(idx.tensors)[:5]}...)")
                stats.n_leaves += 1
                regions, kind = self._leaf_regions(leaf)
                name = _leaf_dtype_name(leaf)
                dtype = dtypes.lookup(name).storage
                buffers: Dict[Region, np.ndarray] = {}
                for region in regions:
                    buf = np.empty(
                        tuple(hi - lo for lo, hi in region), dtype)
                    buffers[region] = buf
                    self._plan_region(run, idx.tensors[pstr], region,
                                      buf, tasks, pstr, name)
                assembled.append((kind, leaf, buffers, pstr))
            else:
                assembled.append(("object", leaf, None, pstr))
        t1 = time.perf_counter()
        stats.plan_s += t1 - t0
        obs.add_span("restore.plan", t0, t1, leaves=len(assembled),
                     tasks=len(tasks), flow=run.flow)

        self._run_tasks(run, tasks)
        return treedef, assembled, idx

    def _assemble(self, run: _Run, treedef, assembled,
                  idx: RestoreIndex) -> Any:
        """Host buffers -> leaves; objects resolved from ``idx`` (for a
        chain restore: the newest step's object log)."""
        stats = run.stats
        t0 = time.perf_counter()
        out = []
        for kind, leaf, aux, pstr in assembled:
            if kind == "object":
                out.append(idx.objects[pstr]()
                           if pstr in idx.objects else leaf)
            elif kind == "numpy":
                out.append(next(iter(aux.values())))
            elif kind == "dtensor":  # this rank's region, on its device
                from torch.distributed.tensor import DTensor
                local = dtypes.host_to_tensor(next(iter(aux.values())),
                                              _leaf_dtype_name(leaf),
                                              leaf.to_local().device)
                out.append(DTensor.from_local(
                    local, leaf.device_mesh, leaf.placements,
                    run_check=False, shape=leaf.shape,
                    stride=leaf.stride()))
            elif kind == "sharded":  # one tensor a region, on the mesh
                name = _leaf_dtype_name(leaf)
                out.append(ShardedTensor(
                    leaf.shape, leaf.dtype, leaf.mesh, leaf.spec,
                    {region: dtypes.host_to_tensor(buf, name, leaf.device)
                     for region, buf in aux.items()}))
            else:  # torch: built on the template leaf's device
                out.append(dtypes.host_to_tensor(
                    next(iter(aux.values())), _leaf_dtype_name(leaf),
                    leaf.device))
        tree = treedef(out)
        t1 = time.perf_counter()
        stats.assemble_s += t1 - t0
        obs.add_span("restore.assemble", t0, t1, flow=run.flow,
                     flow_phase="end")
        return tree

    def restore(self, sdir: str, template: Any
                ) -> Tuple[Any, RestoreStats]:
        """Rebuild a ``template``-shaped pytree from ``sdir``.

        Array leaves (``torch.Tensor``/``ShardedTensor``/``np.ndarray``)
        are reassembled from whichever stored shards intersect each target
        region and land on the template leaf's device (a sharded template:
        one tensor a unique region, on its mesh); non-array leaves come from the object log (or keep
        their template value). Returns ``(tree, stats)``.
        """
        run = _Run(RestoreStats(threads=self.threads))
        try:
            treedef, assembled, idx = self._read_step(run, sdir, template)
            tree = self._assemble(run, treedef, assembled, idx)
            return tree, run.stats
        finally:
            run.fds.close()

    # ------------------------------------------------------- chain restore
    def restore_chain(self, sdirs: Sequence[str], template: Any
                      ) -> Tuple[Any, RestoreStats]:
        """Replay a differential chain: ``sdirs[0]`` is the keyframe step
        directory, ``sdirs[1:]`` the delta steps in chain order.

        The keyframe restores exactly like a full snapshot (same planned
        ranged-read fan-out, elastic across target shardings); each delta
        step's compressed XOR payloads are then decompressed (once per
        stored shard, whatever the target sharding) and folded into the
        in-place host buffers (kernel-backed XOR). Steps apply strictly
        in chain order, and within a step any raw re-saved tensors
        overwrite *before* XOR folds run, so mixed raw/encoded steps are
        deterministic. Objects (RNG state, data-pipeline cursors, step
        metadata) always come from the *newest* step — every save
        persists its objects in full.
        """
        if not sdirs:
            raise ValueError("restore_chain needs at least one step dir")
        run = _Run(RestoreStats(threads=self.threads))
        try:
            treedef, assembled, idx = self._read_step(run, sdirs[0],
                                                      template)
            for sdir in sdirs[1:]:
                idx = self._apply_delta_dir(run, sdir, assembled)
            tree = self._assemble(run, treedef, assembled, idx)
            return tree, run.stats
        finally:
            run.fds.close()

    def _apply_delta_dir(self, run: _Run, sdir: str,
                         assembled) -> RestoreIndex:
        """Fold one delta step's encoded shards into the leaf buffers."""
        stats = run.stats
        t0 = time.perf_counter()
        idx = self.index(sdir, stats, run.lock)
        t1 = time.perf_counter()
        stats.index_s += t1 - t0
        obs.add_span("restore.index", t0, t1, dir=os.path.basename(sdir),
                     delta=True, flow=run.flow)
        stats.n_files += idx.n_files
        xor_tasks: List[Callable[[], Tuple[int, int]]] = []
        raw_tasks: List[Callable[[], Tuple[int, int]]] = []
        t0 = time.perf_counter()
        for kind, leaf, aux, pstr in assembled:
            if kind == "object":
                continue
            enc = idx.delta_tensors.get(pstr, ())
            raw = idx.tensors.get(pstr, ())
            if not enc and not raw:
                raise RestoreError(
                    f"delta step {sdir!r} does not cover tensor {pstr!r} "
                    f"— the chain was built across a reshard without a "
                    f"keyframe?")
            # one task per stored shard: the payload is decompressed once
            # and folded into every intersecting target region
            for rd, entry in enc:
                xor_tasks.append(self._make_delta_task(run, rd, entry,
                                                       aux, pstr))
            if raw:
                # a raw tensor inside a delta step (re-saved whole):
                # overwrite semantics via the normal ranged-read path —
                # executed as a separate batch *before* the XOR folds so
                # mixed raw/encoded steps stay deterministic
                for region, buf in aux.items():
                    self._plan_region(run, list(raw), region, buf,
                                      raw_tasks, pstr,
                                      _leaf_dtype_name(leaf))
        t1 = time.perf_counter()
        stats.plan_s += t1 - t0
        obs.add_span("restore.plan", t0, t1, delta=True, flow=run.flow)
        self._run_tasks(run, raw_tasks)
        self._run_tasks(run, xor_tasks, phase="fold")
        return idx

    def _make_delta_task(self, run: _Run, rd, entry,
                         buffers: Dict[Region, np.ndarray], pstr: str
                         ) -> Callable[[], Tuple[int, int]]:
        def task():
            src_index = entry.index if entry.index is not None \
                else tuple((0, d) for d in entry.shape)
            inters = []
            for region, buf in buffers.items():
                inter = tuple((max(a, c), min(b, d))
                              for (a, b), (c, d) in zip(region, src_index))
                if not any(lo >= hi for lo, hi in inter):
                    inters.append((region, buf, inter))
            if not inters:
                return 0, 0
            dtype = dtypes.lookup(entry.dtype).storage
            if any(dtype != buf.dtype for _r, buf, _i in inters):
                raise RestoreError(
                    f"{pstr!r}: template dtype != stored dtype {dtype} — "
                    f"dtype-converting restore is not defined for XOR "
                    f"delta chains")
            from .state_provider import xor_bytes
            comp_nb = sum(c[1] for c in entry.enc_chunks or ())
            delta = rd.read_encoded_delta(entry.name, self.device) \
                .view(dtype).reshape(entry.shape)
            for region, buf, inter in inters:
                src_sl = tuple(slice(lo - c, hi - c)
                               for (lo, hi), (c, _d) in zip(inter,
                                                            src_index))
                dst_sl = tuple(slice(lo - a, hi - a)
                               for (lo, hi), (a, _b) in zip(inter, region))
                dst_view = buf[dst_sl] if dst_sl else buf[...]
                sub = delta[src_sl] if src_sl else delta[...]
                cur = np.ascontiguousarray(dst_view)
                cur_b = cur.reshape(-1).view(np.uint8)
                sub_b = np.ascontiguousarray(sub).reshape(-1).view(np.uint8)
                folded = xor_bytes(cur_b, sub_b, self.device) \
                    .view(cur.dtype).reshape(cur.shape)
                if dst_sl:
                    buf[dst_sl] = folded
                else:
                    buf[...] = folded
            return comp_nb, len(entry.enc_chunks or ())
        return task
