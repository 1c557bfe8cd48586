"""Composable state providers (paper §V-A3).

A *state provider* (SP) encapsulates per-data-structure knowledge — residency
(device vs. host), type (byte-addressable tensor vs. Python object), layout,
and (de)serialization needs — and exposes a uniform, stream-oriented view to
the data-movement engine: an iterator of :class:`Chunk` byte ranges. The
engine stays agnostic to heterogeneity and only optimizes multi-tier I/O.

* :class:`TensorStateProvider` — zero-copy. Host-resident tensors stream
  memoryviews of their own buffers; device-resident tensors stream views of
  their staged copy in the pinned :class:`~repro_torch.core.host_cache.HostCache`
  reservation, chunk by chunk as D2H staging progresses (so flushing of a
  tensor overlaps with staging of its own tail — paper §V-A4 / Fig 15).
* :class:`ObjectStateProvider` — serializes Python objects (pickle/msgpack)
  lazily at stream time; its chunks carry no fixed offset and are appended
  log-structured (paper §V-A5).
* :class:`CompositeStateProvider` — hierarchical composition: plans the
  fixed-offset tensor region for one file, orders the stream tensors-first
  (largest first) so object serialization overlaps with bulk tensor I/O.
* :class:`QuantizedStateProvider` — per-row int8 quantization of fp32
  state on the engine's device (self-contained ``int8q+zstd`` payloads, so
  quantized tensors restore standalone — see :mod:`repro_torch.core.codecs`).
* :class:`DeltaStateProvider` — differential checkpointing on the main
  engine path (paper §VII / ByteCheckpoint): XOR-deltas each staged chunk
  against a retained previous-snapshot copy held in a
  :class:`SnapshotCache` (inside the same pinned host-cache budget), and
  emits ``codec="xor+zstd"`` chunks that the engine's flush lanes compress
  and log-append. The XOR and its digest run on the engine's device (the
  fused CUDA kernel on a card), a piece of chunks a launch. Keyframe
  saves stream raw (fixed-offset) chunks while refreshing the snapshot
  cache, so the chain can restart at any time.
"""

from __future__ import annotations

import dataclasses
import pickle
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, \
    Tuple

import numpy as np
import torch

from repro_torch.analysis.locks import declares_lock
from repro_torch.obs import trace as obs
from repro_torch.obs.metrics import metrics as obs_metrics

from . import msgpack_lite
from .codecs import (DELTA_CODEC, INT8_CODEC, INT8_ROW_BYTES, PIECE_BYTES,
                     PIECE_CHUNKS, DeltaEncodePiece, Int8EncodePiece,
                     int8_encoded_nbytes, payload_digest, piece_groups)
from .host_cache import HostCache, Reservation
from .layout import FileLayout

DEFAULT_CHUNK_BYTES = 16 * 1024 * 1024
#: a delta piece takes at most 1/DELTA_BUDGET_SHARE of the encode budget:
#: a delta payload is as large as its raw bytes, and a piece that took the
#: whole budget would hold the next one back until every chunk had
#: flushed. Half (32 MiB, 8 chunks of 4 MiB, of the engine's 64 MiB) gave
#: the shortest delta encode in turns against a quarter and an eighth,
#: with persist times within their spread (python -m
#: repro_torch.kernels.variants deltapath; PERF.md)
DELTA_BUDGET_SHARE = 2
#: a delta piece's raw bytes where no budget is set
DELTA_PIECE_BYTES = 32 << 20


@dataclasses.dataclass
class Chunk:
    """One byte range to persist. ``offset is None`` → log-append."""

    name: str
    kind: str                      # "tensor" | "object"
    data: Any                      # memoryview | bytes
    offset: Optional[int] = None   # fixed file offset; None = append
    codec: str = "raw"
    last: bool = False             # last chunk of this logical item
    # For encoded (``codec != "raw"``) tensor chunks: which byte range of
    # the *raw* tensor this chunk encodes — the flush lane compresses the
    # payload, so raw addressing must travel with the chunk.
    raw_range: Optional[Tuple[int, int]] = None
    # Integrity digest of the (uncompressed) encoded payload, emitted by
    # the fused encoder in the same pass that produced ``data``; recorded
    # per chunk in the file footer. None when checksums are off.
    digest: Optional[int] = None
    # Invoked by the flush lane once this chunk's payload is written (or
    # its write failed) — encoded chunks use it to credit the producer's
    # in-flight byte budget.
    on_flushed: Optional[Callable[[], None]] = None


@declares_lock("encode.budget", rank=56, attrs=("_cond",))
class EncodeBudget:
    """Caps the bytes of freshly-allocated encoded (XOR) payloads queued
    between producer and flush lanes.

    Raw-path chunks are zero-copy views into budgeted cache reservations,
    but delta chunks are fresh heap arrays: an unbounded flush queue would
    transiently hold ~one full uncompressed state copy outside the pinned
    host-cache budget (producers XOR at memcpy speed, flush lanes drain at
    compress+disk speed). Producers acquire before allocating; the flush
    lane credits back after the write — always, including error paths, so
    a failed save cannot starve the producer. A single over-cap request is
    admitted when nothing is in flight, so the cap never deadlocks.
    """

    def __init__(self, cap_bytes: int):
        self.cap = int(cap_bytes)
        self._used = 0
        self._cond = threading.Condition()

    def acquire(self, nbytes: int) -> None:
        with self._cond:
            while self._used > 0 and self._used + nbytes > self.cap:
                self._cond.wait(timeout=60.0)
            self._used += nbytes

    def try_acquire(self, nbytes: int) -> bool:
        """:meth:`acquire` if it would not wait; False (nothing taken)
        otherwise."""
        with self._cond:
            if self._used > 0 and self._used + nbytes > self.cap:
                return False
            self._used += nbytes
            return True

    def release(self, nbytes: int) -> None:
        with self._cond:
            self._used -= nbytes
            self._cond.notify_all()


@dataclasses.dataclass(frozen=True)
class DeltaSaveSpec:
    """One save's position in a delta chain (decided by the manager).

    ``keyframe=True`` → stream full raw tensors (and refresh the snapshot
    cache); ``keyframe=False`` → stream XOR deltas against the snapshot
    cache, with ``base_step`` naming the previous save in the chain and
    ``chain_depth`` counting hops back to the keyframe (keyframe = 0).
    """

    step: int
    keyframe: bool
    base_step: Optional[int] = None
    chain_depth: int = 0
    codec: str = DELTA_CODEC

    def manifest_meta(self) -> Dict[str, Any]:
        return {"keyframe": self.keyframe, "base_step": self.base_step,
                "chain_depth": self.chain_depth, "codec": self.codec}


@declares_lock("snapshot.cache", rank=54, attrs=("_lock",))
class SnapshotCache:
    """Per-engine retained previous-snapshot copies, one per tensor name.

    Entries live inside the engine's pinned :class:`HostCache`, so the
    snapshot budget and the staging budget share one back-pressure pool
    (the cache must hold previous-version + in-flight-version bytes for a
    delta save — checked up front by the engine). Thread-safe for the
    per-name access pattern the engine uses (consecutive saves are gated,
    so no two saves mutate the same entry concurrently).
    """

    def __init__(self, cache: HostCache, reserve_timeout_s: float = 60.0):
        self._cache = cache
        self._timeout = reserve_timeout_s
        self._lock = threading.Lock()
        self._entries: Dict[str, Reservation] = {}

    def names(self) -> List[str]:
        with self._lock:
            return list(self._entries)

    def nbytes(self) -> int:
        with self._lock:
            return sum(r.nbytes for r in self._entries.values())

    def view(self, name: str) -> Optional[memoryview]:
        with self._lock:
            res = self._entries.get(name)
        return None if res is None else res.view

    def ensure(self, name: str, nbytes: int) -> torch.Tensor:
        """Reservation for ``name`` sized ``nbytes`` (re-reserved on size
        change), as a flat uint8 tensor over the cache (pinned when the
        cache is, so the delta encode uploads it asynchronously). Raises
        :class:`~.host_cache.CacheFullError` rather than deadlocking when
        the pool cannot hold it."""
        with self._lock:
            res = self._entries.get(name)
            if res is not None and res.nbytes == nbytes:
                return res.tensor()
            if res is not None:
                del self._entries[name]
        if res is not None:
            res.release()
        res = self._cache.reserve(nbytes, timeout=self._timeout)
        with self._lock:
            self._entries[name] = res
        return res.tensor()

    def retain_only(self, names: Sequence[str]) -> None:
        """Drop entries for tensors no longer in the shard set (elastic
        reshard forced a keyframe with a new name set)."""
        keep = set(names)
        with self._lock:
            doomed = [(n, r) for n, r in self._entries.items()
                      if n not in keep]
            for n, _r in doomed:
                del self._entries[n]
        for _n, r in doomed:
            r.release()

    def clear(self) -> None:
        self.retain_only(())


class StateProvider:
    """Base: a named producer of checkpoint chunks."""

    name: str

    def chunks(self) -> Iterator[Chunk]:
        raise NotImplementedError

    def nbytes_hint(self) -> Optional[int]:
        """Size if known a priori (tensors), else None (serialized objects)."""
        return None


@declares_lock("provider.stage", rank=58, attrs=("_cond",))
class TensorStateProvider(StateProvider):
    """Zero-copy SP for a byte-addressable tensor (host or device resident).

    For device arrays, :meth:`bind_reservation` attaches the pinned-cache
    reservation and :meth:`notify_staged` is called by the staging thread as
    bytes land; :meth:`chunks` yields each chunk as soon as its bytes are
    staged, enabling flush/staging overlap within a single large tensor.
    """

    def __init__(self, name: str, *, dtype: str, shape: Tuple[int, ...],
                 nbytes: int, device: torch.device,
                 host_array: Optional[np.ndarray] = None,
                 global_shape: Optional[Tuple[int, ...]] = None,
                 index: Optional[Tuple[Tuple[int, int], ...]] = None,
                 chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                 stream_intra_tensor: bool = True):
        self.name = name
        self.dtype = dtype
        self.shape = tuple(shape)
        self.nbytes = int(nbytes)
        self.global_shape = global_shape
        self.index = index
        # where digests and encodes of the staged bytes run
        self.device = torch.device(device)
        self.chunk_bytes = chunk_bytes
        # False = legacy engines: flush only once the whole tensor is staged.
        self.stream_intra_tensor = stream_intra_tensor
        self.offset: Optional[int] = None  # assigned by composite layout plan
        # host-resident path
        self._host_array = host_array
        # device-resident path
        self._reservation: Optional[Reservation] = None
        self._staged = 0
        self._cond = threading.Condition()
        self._released = False
        # Set by the engine when the save runs with manifest checksums:
        # raw chunks then carry a per-chunk digest of their bytes,
        # recorded in the file footer so verify can localize a flipped
        # chunk inside a keyframe/raw tensor — not just fail the whole
        # file. Encoded providers override the digest with their fused
        # encoder's output instead.
        self.checksum_chunks: bool = False

    # -- residency wiring ----------------------------------------------------
    @property
    def device_resident(self) -> bool:
        return self._host_array is None

    def bind_reservation(self, res: Reservation) -> None:
        self._reservation = res

    @property
    def reservation(self) -> Optional[Reservation]:
        return self._reservation

    def notify_staged(self, nbytes_total: int) -> None:
        """Staging thread reports cumulative bytes landed in the cache."""
        with self._cond:
            self._staged = nbytes_total
            self._cond.notify_all()

    def release(self) -> None:
        """Free the cache reservation once all chunks are flushed."""
        with self._cond:
            if self._released:
                return
            self._released = True
        if self._reservation is not None:
            self._reservation.release()

    # -- StateProvider -------------------------------------------------------
    def nbytes_hint(self) -> Optional[int]:
        return self.nbytes

    def _byte_view(self) -> memoryview:
        if self._host_array is not None:
            arr = np.ascontiguousarray(self._host_array)
            return memoryview(arr).cast("B")
        assert self._reservation is not None, (
            f"device tensor {self.name} streamed before staging was bound")
        return self._reservation.view

    def _staged_bytes(self) -> torch.Tensor:
        """The tensor's bytes as a flat uint8 host tensor: the pinned cache
        reservation for a device tensor, the array itself otherwise."""
        if self._host_array is not None:
            from repro_torch.kernels import ops
            return ops.bytes_on(np.ascontiguousarray(self._host_array)
                                .reshape(-1).view(np.uint8),
                                torch.device("cpu"))
        assert self._reservation is not None, (
            f"device tensor {self.name} streamed before staging was bound")
        return self._reservation.tensor()

    def chunks(self) -> Iterator[Chunk]:
        view = self._byte_view()
        n = self.nbytes
        pos = 0
        while pos < n:
            end = min(pos + self.chunk_bytes, n)
            if self._host_array is None:
                # Wait until staging has landed these bytes (partial-tensor
                # overlap: flush the head while the tail is still in DMA).
                with self._cond:
                    while self._staged < end:
                        self._cond.wait()
            yield Chunk(name=self.name, kind="tensor", data=view[pos:end],
                        offset=self.offset + pos if self.offset is not None else None,
                        raw_range=(pos, end), last=end >= n,
                        digest=self._raw_digest(view[pos:end]))
            pos = end

    def _raw_digest(self, data) -> Optional[int]:
        """Per-chunk digest of a raw chunk's bytes while they are hot from
        the staging copy. Deliberately *not* counted against
        ``engine.bytes_encode_read`` — that counter is the encoded routes'
        single-read-of-staged-bytes equality and raw chunks never encode."""
        if not self.checksum_chunks:
            return None
        with obs.span("encode.digest", tensor=self.name, bytes=len(data)):
            return payload_digest(np.frombuffer(data, dtype=np.uint8),
                                  self.device)


def xor_bytes(cur: np.ndarray, prev: np.ndarray,
              device: torch.device) -> np.ndarray:
    """Bit-exact XOR of two equal-length byte arrays, computed on
    ``device`` (the ``delta_xor`` CUDA kernel on a card, its plain version
    on the CPU); returns a fresh uint8 array."""
    from repro_torch.kernels import ops
    return ops.host_delta_xor(cur, prev, device)


class _StartedPiece:
    """A piece of an encoded provider whose encode is under way: its
    chunks' raw ranges and payload sizes (reserved in the encode budget),
    the encode, and how many chunks were handed on."""

    def __init__(self, spans, enc, piece, t0: float,
                 budget: Optional[EncodeBudget]):
        self.spans, self.enc, self.piece = spans, enc, piece
        self.t0, self.budget = t0, budget
        self.yielded = 0

    def abandon(self) -> None:
        """Credit back the chunks never handed on, once the device is done
        reading the staged bytes."""
        self.piece.wait()
        if self.budget is not None:
            self.budget.release(sum(self.enc[self.yielded:]))


class _PieceEncoder:
    """What the delta and the quantized providers share: a tensor's chunks
    encoded a piece at a time (:func:`~.codecs.piece_groups`). Once a piece
    is staged, its payload bytes are reserved in the encode budget at
    once, and one launch encodes every chunk of it on the engine's device
    from the staged bytes; its payloads are views of one buffer (pinned on
    a card) read back by the same enqueue. While the flush lanes take
    piece ``k``, piece ``k + 1`` is already enqueued on the card, where it
    is staged and the budget admits it without waiting; so at most two
    pieces are in flight. A subclass gives the payload sizes
    (:meth:`_payload_nbytes`), the encode (:meth:`_encode`, an object with
    ``wait()`` and ``result()``) and what each chunk needs before it is
    handed on (:meth:`_check`)."""

    encode_span = ""

    def _payload_nbytes(self, spans) -> List[int]:
        raise NotImplementedError

    def _encode(self, src: torch.Tensor, lo: int, hi: int, spans):
        raise NotImplementedError

    def _check(self, a: int, b: int, nb: int, payload) -> None:
        raise NotImplementedError

    def _start(self, spans, src: torch.Tensor, wait: bool
               ) -> Optional[_StartedPiece]:
        """Enqueue the encode of one piece, once it is staged and its
        payloads are reserved in the budget; with ``wait=False`` only if
        neither has to wait (else None)."""
        lo, hi = spans[0][0], spans[-1][1]
        if self._host_array is None:
            with self._cond:
                if not wait and self._staged < hi:
                    return None
                while self._staged < hi:
                    self._cond.wait()
        # the payload sizes are known before encoding, so the piece's
        # footprint is reserved once, before the encode allocates it
        enc = self._payload_nbytes(spans)
        budget = self.encode_budget
        if budget is not None:
            if wait:
                budget.acquire(sum(enc))
            elif not budget.try_acquire(sum(enc)):
                return None
        t0 = time.perf_counter()
        try:
            piece = self._encode(src, lo, hi, spans)
            obs_metrics.inc("engine.bytes_encode_read", hi - lo)
        except BaseException:
            # un-yielded chunks credit their own reservations back
            if budget is not None:
                budget.release(sum(enc))
            raise
        return _StartedPiece(spans, enc, piece, t0, budget)

    def _emit(self, started: _StartedPiece) -> Iterator[Chunk]:
        """The piece's chunks, once its encode is done."""
        results = started.piece.result()
        lo, hi = started.spans[0][0], started.spans[-1][1]
        obs.add_span(self.encode_span, started.t0, time.perf_counter(),
                     tensor=self.name, bytes=hi - lo,
                     chunks=len(started.spans), fused=True)
        budget = started.budget
        for (a, b), nb, (payload, digest) in zip(started.spans, started.enc,
                                                 results):
            self._check(a, b, nb, payload)
            chunk = Chunk(name=self.name, kind="tensor", data=payload,
                          offset=None, codec=self.enc_codec,
                          raw_range=(a, b), last=b >= self.nbytes,
                          digest=digest if self.checksum_chunks else None,
                          on_flushed=None if budget is None else
                          (lambda nb=nb: budget.release(nb)))
            started.yielded += 1
            yield chunk

    def _piece_chunks(self, max_chunks: int, max_bytes: int
                      ) -> Iterator[Chunk]:
        """Every chunk of the tensor, encoded in pieces of at most
        ``max_chunks`` chunks and ``max_bytes`` raw bytes."""
        src = self._staged_bytes()
        n = self.nbytes
        pieces = list(piece_groups(
            [(pos, min(pos + self.chunk_bytes, n))
             for pos in range(0, n, self.chunk_bytes)],
            max_chunks, max_bytes))
        if not pieces:
            return
        live = [self._start(pieces[0], src, wait=True)]
        try:
            for k in range(len(pieces)):
                nxt = pieces[k + 1] if k + 1 < len(pieces) else None
                if nxt is not None:
                    ahead = self._start(nxt, src, wait=False)
                    if ahead is not None:
                        live.append(ahead)
                yield from self._emit(live[0])
                live.pop(0)
                if nxt is not None and not live:
                    live.append(self._start(nxt, src, wait=True))
        finally:
            for started in live:
                started.abandon()


class DeltaStateProvider(_PieceEncoder, TensorStateProvider):
    """Differential SP: streams XOR deltas against the previous snapshot.

    Two modes, chosen per save by the manager's chain tracker
    (:class:`DeltaSaveSpec`):

    * **keyframe** — behaves like :class:`TensorStateProvider` (raw chunks
      at fixed offsets) but additionally copies each staged chunk into the
      engine's :class:`SnapshotCache`, re-arming the chain;
    * **delta** — each staged chunk is XORed against the retained snapshot
      bytes (kernel-backed), the snapshot entry is advanced to the current
      bytes, and the XOR payload is emitted as a ``codec="xor+zstd"``
      log-append chunk (``offset=None`` — encoded tensors never occupy the
      fixed region, so bytes-on-disk shrink with the delta). Compression
      happens downstream on the engine's flush lanes, keeping capture and
      producer latency flat.

    The delta mode encodes a piece of chunks at a time
    (:class:`_PieceEncoder`, :class:`~.codecs.DeltaEncodePiece`): the
    piece's staged bytes and its snapshot base are uploaded from the
    pinned host cache, one launch of the fused XOR digest (``delta_xor``
    when checksums are off) encodes every chunk, and the deltas are read
    back into one pinned buffer. A piece holds at most
    1/:data:`DELTA_BUDGET_SHARE` of the encode budget; chunks that are not
    whole 16-byte vectors go one a piece. Each chunk's snapshot bytes are
    advanced from its delta (``base ^ delta == cur``) just before the
    chunk is handed on, so the staged bytes are read once, by the upload.

    XOR is associative and order-insensitive, so restore may fold a chain
    of deltas onto the keyframe in any order (``RestoreEngine.restore_chain``).
    """

    encode_span = "encode.delta"

    def __init__(self, name: str, *, prev, keyframe: bool,
                 codec: str = DELTA_CODEC, **kw):
        super().__init__(name, **kw)
        self.keyframe = keyframe
        self.delta_codec = codec
        self.enc_codec = codec  # uniform encoded-provider attribute
        # the snapshot base: the pinned cache reservation's tensor (or any
        # writable buffer, viewed as one)
        self._prev = prev if isinstance(prev, torch.Tensor) \
            else torch.from_numpy(np.frombuffer(prev, dtype=np.uint8))
        # set by the engine: fired exactly once when this provider's chunk
        # stream ends (exhausted, closed, or abandoned by a failed
        # producer) — the signal that its snapshot-cache entry is settled
        # and the next save may start streaming.
        self.on_stream_end: Optional[Callable[[], None]] = None
        # Set by the engine to the save's `captured` event: streaming (and
        # with it every producer-lane memcpy/XOR) is deferred until the
        # device is fully drained, so the D2H staging lane never contends
        # with encode work for the GIL — capture latency (the metric that
        # blocks training) stays identical to the raw path; the XOR +
        # compress pipeline runs in the shadow of the next iteration.
        # Applied to keyframe mode too, deliberately: the keyframe's
        # snapshot-cache refresh is a producer-lane memcpy that measurably
        # (~2×) inflated capture when overlapped with staging; trading
        # async persist tail for zero training stall is the right side of
        # that bargain.
        self.capture_gate: Optional[threading.Event] = None
        # Set by the engine: bounds in-flight freshly-allocated XOR
        # payload bytes between producer and flush lanes.
        self.encode_budget: Optional[EncodeBudget] = None
        # checksum_chunks (inherited) additionally makes the fused encoder
        # emit a per-chunk payload digest in the same pass as the delta.
        assert self._prev.numel() == self.nbytes, (
            f"snapshot cache entry for {name} is {self._prev.numel()} B, "
            f"tensor is {self.nbytes} B")

    @property
    def fixed_offset(self) -> bool:
        """Keyframes live in the planned fixed-offset region; deltas are
        compressed downstream and log-appended."""
        return self.keyframe

    def _signal_stream_end(self) -> None:
        cb, self.on_stream_end = self.on_stream_end, None
        if cb is not None:
            cb()

    def chunks(self) -> Iterator[Chunk]:
        try:
            if self.capture_gate is not None:
                self.capture_gate.wait()
            if self.keyframe:
                yield from self._keyframe_chunks()
                return
            budget = self.encode_budget
            max_bytes = DELTA_PIECE_BYTES if budget is None \
                else budget.cap // DELTA_BUDGET_SHARE
            # the kernel takes any number of segments: only the bytes
            # bound a piece, unless its chunks cannot be segments
            max_chunks = 1 if self.chunk_bytes % 16 else self.nbytes
            yield from self._piece_chunks(max_chunks, max_bytes)
        finally:
            self._signal_stream_end()

    def _keyframe_chunks(self) -> Iterator[Chunk]:
        """Raw chunks, each copied into the snapshot as it is staged; the
        per-chunk digest rides the same pass while the bytes are hot from
        the snapshot memcpy, closing the keyframe half of the
        verify-localization story."""
        view = self._byte_view()
        prev = self._prev.numpy()
        n = self.nbytes
        for pos in range(0, n, self.chunk_bytes):
            end = min(pos + self.chunk_bytes, n)
            if self._host_array is None:
                with self._cond:
                    while self._staged < end:
                        self._cond.wait()
            prev[pos:end] = np.frombuffer(view[pos:end], dtype=np.uint8)
            yield Chunk(name=self.name, kind="tensor", data=view[pos:end],
                        offset=self.offset + pos
                        if self.offset is not None else None,
                        raw_range=(pos, end), last=end >= n,
                        digest=self._raw_digest(view[pos:end]))

    def _payload_nbytes(self, spans) -> List[int]:
        return [b - a for a, b in spans]

    def _encode(self, src: torch.Tensor, lo: int, hi: int, spans
                ) -> DeltaEncodePiece:
        return DeltaEncodePiece(src[lo:hi], self._prev[lo:hi],
                                self.chunk_bytes, self.checksum_chunks,
                                self.device)

    def _check(self, a: int, b: int, nb: int, payload) -> None:
        # advance the chain base without touching the staged bytes again:
        # base ^ delta == cur bit-exactly
        base = self._prev.numpy()[a:b]
        np.bitwise_xor(base, payload, out=base)


class QuantizedStateProvider(_PieceEncoder, TensorStateProvider):
    """Compressed SP: per-row int8 quantization of fp32 state (4x).

    Each staged chunk is cut on quantization-row boundaries, quantized on
    the engine's device with per-row symmetric scales and emitted as a
    self-contained ``codec="int8q+zstd"`` log-append payload that the
    flush lanes compress. Like the delta path, encoded tensors never
    occupy the fixed region; unlike it the payloads have no chain base, so
    a quantized tensor restores standalone, selective per-domain restores
    included, at a loss of at most half a quantization step per value.

    The chunks are encoded a piece at a time (:class:`_PieceEncoder`: up
    to 16 chunks, 64 MiB of raw bytes): :class:`~.codecs.Int8EncodePiece`
    uploads a piece from the pinned host cache, encodes every chunk in one
    launch (the fused quantize+digest kernel on a card) and reads the
    payloads back into one pinned buffer.

    The natural routing target is optimizer state
    (``ProviderRule(domain="optimizer", dtype="float32",
    provider="quantized")``) while params stay raw or delta-encoded; a
    non-fp32 leaf routed here is an error at construction.
    """

    encode_span = "encode.int8"

    def __init__(self, name: str, *, codec: str = INT8_CODEC, **kw):
        super().__init__(name, **kw)
        if np.dtype(self.dtype) != np.float32:
            raise ValueError(
                f"QuantizedStateProvider requires float32 state; "
                f"{name!r} is {self.dtype} — scope the registry rule "
                f"with dtype='float32'")
        self.enc_codec = codec
        # chunk boundaries land on whole quantization rows, so every
        # payload decodes on its own
        self.chunk_bytes = max(
            INT8_ROW_BYTES,
            self.chunk_bytes - self.chunk_bytes % INT8_ROW_BYTES)
        # same engine wiring as DeltaStateProvider: encode work waits for
        # the save's captured event, so the staging lane runs uncontended,
        # and fresh payload allocations are bounded by the encode budget
        self.capture_gate: Optional[threading.Event] = None
        self.encode_budget: Optional[EncodeBudget] = None

    @property
    def fixed_offset(self) -> bool:
        return False

    def _payload_nbytes(self, spans) -> List[int]:
        return [int8_encoded_nbytes(b - a) for a, b in spans]

    def _encode(self, src: torch.Tensor, lo: int, hi: int, spans
                ) -> Int8EncodePiece:
        return Int8EncodePiece(src[lo:hi], [b - lo for _a, b in spans],
                               self.device)

    def _check(self, a: int, b: int, nb: int, payload) -> None:
        if len(payload) != nb:
            raise RuntimeError(
                f"{self.name}: int8q payload of {len(payload)} B, "
                f"expected {nb} B")

    def chunks(self) -> Iterator[Chunk]:
        if self.capture_gate is not None:
            self.capture_gate.wait()
        yield from self._piece_chunks(PIECE_CHUNKS, PIECE_BYTES)


class ObjectStateProvider(StateProvider):
    """SP for non-tensor Python state (dicts, RNG seeds, config, ...).

    Serialization happens lazily inside :meth:`chunks` — i.e. on the engine's
    producer thread, *after* tensor chunks have been enqueued — so it overlaps
    with bulk tensor I/O instead of blocking the training loop (§V-A5).
    """

    def __init__(self, name: str, obj: Any, codec: str = "pickle",
                 chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                 preserialized: Optional[bytes] = None):
        self.name = name
        self._obj = obj
        self.codec = codec
        self.chunk_bytes = chunk_bytes
        self._preserialized = preserialized
        self.serialized_nbytes: Optional[int] = (
            len(preserialized) if preserialized is not None else None)

    def serialize(self) -> bytes:
        if self._preserialized is not None:  # legacy blocking-upfront engines
            return self._preserialized
        if self.codec == "pickle":
            payload = pickle.dumps(self._obj, protocol=pickle.HIGHEST_PROTOCOL)
        elif self.codec == "msgpack":
            payload = msgpack_lite.packb(self._obj)
        else:
            raise ValueError(f"unknown codec {self.codec}")
        self.serialized_nbytes = len(payload)
        return payload

    def chunks(self) -> Iterator[Chunk]:
        payload = self.serialize()
        n = len(payload)
        if n == 0:
            yield Chunk(name=self.name, kind="object", data=b"",
                        codec=self.codec, last=True)
            return
        for pos in range(0, n, self.chunk_bytes):
            end = min(pos + self.chunk_bytes, n)
            yield Chunk(name=self.name, kind="object",
                        data=payload[pos:end], codec=self.codec,
                        last=end >= n)


class CompositeStateProvider(StateProvider):
    """Hierarchical composition of SPs targeting one checkpoint file.

    Responsibilities (paper §V-A3): (a) compute sizes/offsets for the fixed
    region, (b) group/order chunks for the persistent layout, (c) stream
    tensors first — largest first — so the engine is busy with bulk I/O while
    object serialization proceeds.
    """

    def __init__(self, name: str, providers: Sequence[StateProvider]):
        self.name = name
        self.tensor_providers: List[TensorStateProvider] = [
            p for p in providers if isinstance(p, TensorStateProvider)]
        self.object_providers: List[ObjectStateProvider] = [
            p for p in providers if isinstance(p, ObjectStateProvider)]
        composites = [p for p in providers if isinstance(p, CompositeStateProvider)]
        for c in composites:  # hierarchical merge
            self.tensor_providers.extend(c.tensor_providers)
            self.object_providers.extend(c.object_providers)
        self._layout: Optional[FileLayout] = None

    def plan_layout(self) -> FileLayout:
        """Fix tensor offsets (largest-first order = stream order).

        Only providers with ``fixed_offset`` (raw tensors, keyframes) get
        fixed-region offsets; encoded providers (delta mode) are excluded —
        their compressed chunks log-append, so the file never reserves
        their raw footprint."""
        if self._layout is None:
            self.tensor_providers.sort(key=lambda p: -p.nbytes)
            fixed = [p for p in self.tensor_providers
                     if getattr(p, "fixed_offset", True)]
            specs = [(p.name, p.nbytes, p.dtype, p.shape, p.global_shape,
                      p.index) for p in fixed]
            self._layout = FileLayout.plan(specs)
            for p, entry in zip(fixed, self._layout.tensors):
                p.offset = entry.offset
        return self._layout

    def encoded_providers(self) -> List[TensorStateProvider]:
        return [p for p in self.tensor_providers
                if not getattr(p, "fixed_offset", True)]

    def nbytes_hint(self) -> Optional[int]:
        return sum(p.nbytes for p in self.tensor_providers)

    def chunks(self) -> Iterator[Chunk]:
        self.plan_layout()
        for p in self.tensor_providers:   # bulk zero-copy I/O first
            yield from p.chunks()
        for p in self.object_providers:   # serialization overlapped w/ flush
            yield from p.chunks()
