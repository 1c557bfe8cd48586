"""Hybrid fixed-offset / log-structured-append checkpoint file layout.

Implements the persistent format of DataStates-LLM (paper §V-A5):

* **Tensor region** — tensors have sizes known a priori, so their offsets are
  precomputed and fixed; every tensor start is aligned to ``ALIGN`` bytes so a
  direct-I/O (``O_DIRECT``/liburing-style) backend could be swapped in.
* **Object log region** — serialized Python objects have sizes unknown until
  serialization finishes, so their chunks are appended log-structured starting
  at the end of the tensor region (offsets assigned at append time).
* **Footer** — a trailing metadata header (msgpack) describing the layout of
  both regions, followed by ``u64 footer_len`` + ``MAGIC``, appended last.
  It is packed by :mod:`~repro_torch.core.msgpack_lite`, byte-identical to
  the ``msgpack`` package, so both packages read each other's files.

Readers open the file, read the trailing 16 bytes, then the footer, and can
lazily fetch any tensor (zero-copy via ``np.memmap``) or object. Tensors
come back as numpy arrays of their dtype's host storage type
(:mod:`~repro_torch.core.dtypes`: ``uint16`` for ``bfloat16``).
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import struct
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.analysis.locks import declares_lock
from repro_torch.obs import trace as obs
from repro_torch.obs.metrics import metrics as obs_metrics

from . import dtypes, msgpack_lite

MAGIC = b"DSLLMCK1"
ALIGN = 4096
_TRAILER = struct.Struct("<Q8s")  # footer_len, magic


def maybe_fsync(fd: int) -> None:
    """fsync unless REPRO_NO_FSYNC=1 (the same switch as the JAX package:
    benchmarks that model storage bandwidth themselves turn the flush off)."""
    if os.environ.get("REPRO_NO_FSYNC") != "1":
        os.fsync(fd)


def align_up(n: int, align: int = ALIGN) -> int:
    return (n + align - 1) // align * align


@dataclasses.dataclass(frozen=True)
class TensorEntry:
    """A tensor (or tensor shard), either placed at a fixed offset
    (``codec == "raw"``) or encoded into log-appended compressed chunks
    (differential checkpointing: ``codec == "xor+zstd"``)."""

    name: str
    offset: int                    # fixed-region offset; -1 for encoded
    nbytes: int                    # raw (decoded) byte size
    dtype: str
    shape: Tuple[int, ...]
    # Global-shard bookkeeping (which slice of the logical array this is).
    global_shape: Optional[Tuple[int, ...]] = None
    index: Optional[Tuple[Tuple[int, int], ...]] = None  # (start, stop) per dim
    checksum: Optional[int] = None
    codec: str = "raw"
    # Encoded tensors: (file_offset, comp_nbytes, raw_lo, raw_hi, digest)
    # per compressed chunk — raw addressing is explicit, so flush-lane
    # append order never matters for reconstruction. ``digest`` is the
    # position-weighted u32 checksum of the *uncompressed* payload (the
    # fused encoder emits it in the same pass that produced the payload);
    # ``None`` when the save ran without manifest checksums, or in footers
    # written before digests existed (legacy 4-tuples).
    enc_chunks: Optional[List[Tuple[int, int, int, int, Optional[int]]]] = None
    # Raw (fixed-offset) tensors saved with manifest checksums:
    # (raw_lo, raw_hi, digest) per write chunk — the keyframe/raw
    # counterpart of ``enc_chunks`` digests, so verify can localize a
    # flipped chunk inside a keyframe instead of only failing the whole
    # file's checksum. ``None`` in legacy footers or checksum-less saves.
    raw_chunks: Optional[List[Tuple[int, int, Optional[int]]]] = None


@dataclasses.dataclass(frozen=True)
class ObjectEntry:
    """A serialized Python object appended to the log region."""

    name: str
    offset: int
    nbytes: int
    codec: str = "pickle"


@dataclasses.dataclass
class FileLayout:
    """Precomputed layout for one checkpoint file (paper Fig 1 shard file)."""

    tensors: List[TensorEntry]
    tensor_region_end: int  # aligned end of the fixed-offset region

    @classmethod
    def plan(cls, specs: Sequence[Tuple[str, int, str, Tuple[int, ...],
                                        Optional[Tuple[int, ...]],
                                        Optional[Tuple[Tuple[int, int], ...]]]]
             ) -> "FileLayout":
        """Assign fixed, aligned offsets to tensors with known sizes.

        ``specs``: (name, nbytes, dtype, shape, global_shape, index) tuples.
        """
        entries: List[TensorEntry] = []
        cursor = 0
        for name, nbytes, dtype, shape, gshape, index in specs:
            cursor = align_up(cursor)
            entries.append(TensorEntry(name=name, offset=cursor, nbytes=nbytes,
                                       dtype=dtype, shape=tuple(shape),
                                       global_shape=gshape, index=index))
            cursor += nbytes
        return cls(tensors=entries, tensor_region_end=align_up(cursor))


@declares_lock("writer.append", rank=60, attrs=("_append_lock",))
class FileWriter:
    """Positional writer for one checkpoint file.

    Thread-safe: tensor chunks go to fixed offsets with ``os.pwrite`` (no
    shared cursor), object chunks reserve space on an atomic append cursor in
    the log region. The footer is written by :meth:`finalize`.

    With ``track_checksum=True`` the writer accumulates the manifest-
    compatible file checksum *while writing* (every byte lands exactly once
    at a fixed or append-reserved offset, so the streaming accumulator in
    :mod:`repro_torch.storage.file_format` is exact): each pwrite's contribution
    is computed outside any lock and folded under the existing append lock,
    and :attr:`file_checksum` is valid after :meth:`finalize` — the commit
    lane can reuse it instead of re-reading the file.
    """

    def __init__(self, path: str, layout: FileLayout,
                 track_checksum: bool = False):
        import threading

        self.path = path
        self.layout = layout
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        self._append_lock = threading.Lock()
        self._append_cursor = layout.tensor_region_end
        self._objects: List[ObjectEntry] = []
        self._extra_meta: Dict[str, Any] = {}
        # Encoded-tensor bookkeeping (differential checkpointing): static
        # meta declared by the producer, per-chunk records appended by the
        # flush lanes as compressed payloads land in the log region.
        self._enc_meta: Dict[str, Dict[str, Any]] = {}
        self._enc_chunks: Dict[str, List[Tuple[int, int, int, int,
                                               Optional[int]]]] = {}
        # Per-chunk digests of raw fixed-offset writes (keyframes/plain
        # tensors under manifest checksums), recorded by the flush lanes.
        self._raw_chunks: Dict[str, List[Tuple[int, int,
                                               Optional[int]]]] = {}
        self._csum = None
        if track_checksum:
            from repro_torch.storage.file_format import \
                StreamingFileChecksum
            self._csum = StreamingFileChecksum()
        self._file_checksum: Optional[int] = None

    @property
    def file_checksum(self) -> Optional[int]:
        """Manifest-compatible checksum of the finished file — ``None``
        unless tracking was on and :meth:`finalize` completed."""
        return self._file_checksum

    def _pwrite(self, fd: int, data, offset: int) -> None:
        os.pwrite(fd, data, offset)
        if self._csum is not None:
            contrib = self._csum.contribution(offset, data)
            with self._append_lock:
                self._csum.fold(contrib)

    # -- tensor region ------------------------------------------------------
    def write_at(self, offset: int, data) -> None:
        """Write a (chunk of a) tensor at its fixed offset. GIL-released."""
        self._pwrite(self._fd, data, offset)

    # -- object log region ---------------------------------------------------
    def append_object(self, name: str, payload: bytes, codec: str = "pickle"
                      ) -> ObjectEntry:
        with self._append_lock:
            off = self._append_cursor
            self._append_cursor += len(payload)
        self._pwrite(self._fd, payload, off)
        obs_metrics.inc("writer.append_bytes", len(payload))
        entry = ObjectEntry(name=name, offset=off, nbytes=len(payload),
                            codec=codec)
        with self._append_lock:
            self._objects.append(entry)
        return entry

    # -- encoded tensors (differential checkpointing) ------------------------
    def declare_encoded_tensor(self, name: str, *, dtype: str,
                               shape: Tuple[int, ...], nbytes: int,
                               codec: str,
                               global_shape: Optional[Tuple[int, ...]] = None,
                               index: Optional[Tuple[Tuple[int, int], ...]]
                               = None) -> None:
        """Register the static metadata of a tensor whose payload arrives
        as compressed log-append chunks (the footer needs dtype/shape even
        though no fixed-region offset exists)."""
        with self._append_lock:
            self._enc_meta[name] = {
                "dtype": dtype, "shape": tuple(shape), "nbytes": int(nbytes),
                "codec": codec, "global_shape": global_shape, "index": index}

    def append_encoded_chunk(self, name: str, payload: bytes,
                             raw_lo: int, raw_hi: int,
                             digest: Optional[int] = None) -> None:
        """Append one compressed chunk of an encoded tensor; thread-safe
        (called from concurrent flush lanes). ``digest`` is the fused
        encoder's checksum of the *uncompressed* payload, recorded in the
        footer so decode can verify the chunk without a second pass."""
        with self._append_lock:
            off = self._append_cursor
            self._append_cursor += len(payload)
        self._pwrite(self._fd, payload, off)
        obs_metrics.inc("writer.append_bytes", len(payload))
        with self._append_lock:
            self._enc_chunks.setdefault(name, []).append(
                (off, len(payload), int(raw_lo), int(raw_hi),
                 int(digest) if digest is not None else None))

    def record_raw_chunk(self, name: str, raw_lo: int, raw_hi: int,
                         digest: Optional[int]) -> None:
        """Record the per-chunk digest of one raw fixed-offset write;
        thread-safe (called from concurrent flush lanes). The footer gains
        a ``raw_chunks`` list per tensor so verify can localize a flipped
        chunk in a keyframe the same way it can in a delta."""
        with self._append_lock:
            self._raw_chunks.setdefault(name, []).append(
                (int(raw_lo), int(raw_hi),
                 int(digest) if digest is not None else None))

    def set_meta(self, key: str, value: Any) -> None:
        self._extra_meta[key] = value

    # -- footer --------------------------------------------------------------
    def _encoded_entries(self) -> List[TensorEntry]:
        entries = []
        for name, m in sorted(self._enc_meta.items()):
            chunks = sorted(self._enc_chunks.get(name, ()),
                            key=lambda c: c[2])
            covered = 0
            for _off, _nb, lo, hi, _dig in chunks:
                if lo != covered:
                    break
                covered = hi
            if covered != m["nbytes"]:
                raise ValueError(
                    f"encoded tensor {name!r}: chunks cover {covered} of "
                    f"{m['nbytes']} raw bytes — a flush lane lost a chunk")
            # Tensor-level checksum for free: fold the fused per-chunk
            # digests in raw order (same (i+1)-weighted fold the manifest
            # uses for file chunks) — no extra read of the payload.
            csum = None
            if chunks and all(c[4] is not None for c in chunks):
                csum = 0
                for i, c in enumerate(chunks):
                    csum = (csum + (i + 1) * c[4]) % (1 << 32)
            entries.append(TensorEntry(
                name=name, offset=-1, nbytes=m["nbytes"], dtype=m["dtype"],
                shape=m["shape"], global_shape=m["global_shape"],
                index=m["index"], codec=m["codec"], checksum=csum,
                enc_chunks=chunks))
        return entries

    def _with_raw_chunks(self, entries: List[TensorEntry]
                         ) -> List[TensorEntry]:
        """Attach recorded raw-chunk digests to their fixed-offset entries
        and fold them into a tensor-level checksum (same (i+1)-weighted
        fold the encoded path uses) — no extra read of the payload."""
        out = []
        for t in entries:
            chunks = self._raw_chunks.get(t.name)
            if not chunks:
                out.append(t)
                continue
            chunks = sorted(chunks, key=lambda c: c[0])
            covered = 0
            for lo, hi, _dig in chunks:
                if lo != covered:
                    break
                covered = hi
            if covered != t.nbytes:
                raise ValueError(
                    f"raw tensor {t.name!r}: digest records cover "
                    f"{covered} of {t.nbytes} raw bytes — a flush lane "
                    f"lost a chunk record")
            csum = None
            if all(c[2] is not None for c in chunks):
                csum = 0
                for i, c in enumerate(chunks):
                    csum = (csum + (i + 1) * c[2]) % (1 << 32)
            out.append(dataclasses.replace(t, raw_chunks=chunks,
                                           checksum=csum))
        return out

    def finalize(self, tensor_checksums: Optional[Dict[str, int]] = None) -> None:
        tensors = self._with_raw_chunks(self.layout.tensors) \
            + self._encoded_entries()
        if tensor_checksums:
            tensors = [dataclasses.replace(t, checksum=tensor_checksums[t.name])
                       if t.name in tensor_checksums else t
                       for t in tensors]
        footer = {
            "version": 1,
            "tensors": [dataclasses.asdict(t) for t in tensors],
            "objects": [dataclasses.asdict(o) for o in self._objects],
            "meta": self._extra_meta,
        }
        payload = msgpack_lite.packb(footer)
        with self._append_lock:
            fd = self._fd
            if fd < 0:
                # a concurrent abort() (or double finalize) already closed
                # the file — sealing it now would publish a partial file
                raise ValueError(
                    f"{self.path}: finalize() on a closed/aborted writer")
            # take sole ownership of the fd so a racing abort() cannot
            # close it between our writes below
            self._fd = -1
            off = self._append_cursor
            self._append_cursor += len(payload) + _TRAILER.size
        with obs.span("file.finalize", file=os.path.basename(self.path),
                      footer_bytes=len(payload)):
            trailer = _TRAILER.pack(len(payload), MAGIC)
            os.pwrite(fd, payload, off)
            os.pwrite(fd, trailer, off + len(payload))
            if self._csum is not None:
                # single-threaded here (fd ownership was just taken), so
                # fold directly; after this the accumulator covers every
                # byte of the finished file
                self._csum.update(off, payload)
                self._csum.update(off + len(payload), trailer)
                self._file_checksum = self._csum.value
            maybe_fsync(fd)
            os.close(fd)

    def abort(self) -> None:
        """Close the fd without writing a footer. Idempotent and safe to
        call from concurrent error paths."""
        with self._append_lock:
            fd, self._fd = self._fd, -1
        if fd >= 0:
            os.close(fd)


class FileReader:
    """Reader for the hybrid layout; lazy tensor access via memmap."""

    def __init__(self, path: str):
        self.path = path
        size = os.path.getsize(path)
        if size < _TRAILER.size:
            raise ValueError(f"{path}: too small to be a checkpoint file")
        with open(path, "rb") as f:
            f.seek(size - _TRAILER.size)
            footer_len, magic = _TRAILER.unpack(f.read(_TRAILER.size))
            if magic != MAGIC:
                raise ValueError(f"{path}: bad magic {magic!r}")
            f.seek(size - _TRAILER.size - footer_len)
            footer = msgpack_lite.unpackb(f.read(footer_len))
        self.footer = footer
        self.tensors: Dict[str, TensorEntry] = {
            t["name"]: TensorEntry(**{
                **t,
                "shape": tuple(t["shape"]),
                "global_shape": (tuple(t["global_shape"])
                                 if t["global_shape"] is not None else None),
                "index": (tuple(map(tuple, t["index"]))
                          if t["index"] is not None else None),
                # legacy footers carry 4-tuples (no per-chunk digest);
                # normalize to 5-tuples with digest=None so every consumer
                # sees one shape
                "enc_chunks": ([tuple(c) + (None,) * (5 - len(c))
                                for c in t["enc_chunks"]]
                               if t.get("enc_chunks") is not None else None),
                # absent in footers written before raw-chunk digests
                "raw_chunks": ([tuple(c) for c in t["raw_chunks"]]
                               if t.get("raw_chunks") is not None else None)})
            for t in footer["tensors"]
        }
        self.objects: Dict[str, ObjectEntry] = {
            o["name"]: ObjectEntry(**o) for o in footer["objects"]
        }
        self.meta: Dict[str, Any] = footer.get("meta", {})

    def tensor_names(self) -> List[str]:
        return list(self.tensors)

    def read_tensor(self, name: str,
                    device: torch.device = "cuda") -> np.ndarray:
        """A stored tensor's host array. ``device`` decodes a
        self-contained encoded tensor (the dequantize kernel on a card);
        a raw tensor never touches it."""
        e = self.tensors[name]
        if e.codec != "raw":
            from .codecs import is_chained_codec
            if is_chained_codec(e.codec):
                raise ValueError(
                    f"{name!r} is {e.codec}-encoded (a differential delta); "
                    f"its value depends on the chain base — restore the step "
                    f"through RestoreEngine.restore_chain / "
                    f"CheckpointManager.restore")
            # self-contained encoding (e.g. int8 quantized): decode in place
            return dtypes.host_view(self.read_encoded_tensor(name, device),
                                    e.dtype).reshape(e.shape)
        mm = np.memmap(self.path, mode="r", dtype=np.uint8,
                       offset=e.offset, shape=(e.nbytes,))
        return dtypes.host_view(np.asarray(mm), e.dtype).reshape(e.shape)

    def read_encoded_delta(self, name: str,
                           device: torch.device) -> np.ndarray:
        """Decompressed (but still XOR-domain) bytes of an encoded tensor,
        assembled in raw order. Used by chain replay. Chunks that carry a
        fused-encode digest are integrity-verified on ``device`` as they
        are read."""
        from .codecs import payload_digest
        from .reduction import _decompress
        e = self.tensors[name]
        if e.codec == "raw":
            raise ValueError(f"{name!r} is raw, not encoded")
        out = np.empty(e.nbytes, dtype=np.uint8)
        with open(self.path, "rb") as f:
            for off, comp_nb, lo, hi, dig in sorted(e.enc_chunks or (),
                                                    key=lambda c: c[2]):
                f.seek(off)
                raw = _decompress(f.read(comp_nb))
                if len(raw) != hi - lo:
                    raise ValueError(
                        f"{name!r} chunk [{lo}:{hi}) decompressed to "
                        f"{len(raw)} B — corrupt delta payload")
                out[lo:hi] = np.frombuffer(raw, dtype=np.uint8)
                if dig is not None:
                    got = payload_digest(out[lo:hi], device)
                    if got != dig:
                        raise ValueError(
                            f"{name!r} chunk [{lo}:{hi}) digest mismatch: "
                            f"stored {dig:#010x}, read {got:#010x} — "
                            f"corrupt delta payload")
        return out

    def read_encoded_tensor(self, name: str,
                            device: torch.device) -> np.ndarray:
        """Raw (decoded) bytes of a *self-contained* encoded tensor
        (e.g. ``int8q+zstd`` quantized payloads), assembled in raw order
        and decoded on ``device``; chunks that carry a fused-encode digest
        are verified in the same pass. The codec's decoder takes the
        chunks a piece at a time (one upload and one launch for up to 16
        chunks; on a card the next piece is read and decompressed while
        the card decodes this one). Chained codecs (XOR deltas) must go
        through :meth:`read_encoded_delta` + chain replay instead."""
        from .codecs import is_chained_codec, tensor_decoder
        from .reduction import _decompress
        e = self.tensors[name]
        if e.codec == "raw":
            raise ValueError(f"{name!r} is raw, not encoded")
        if is_chained_codec(e.codec):
            raise ValueError(
                f"{name!r} is {e.codec}-encoded (a differential delta); "
                f"restore it through chain replay, not standalone decode")
        out = np.empty(e.nbytes, dtype=np.uint8)
        decoder = tensor_decoder(e.codec, out, device)
        covered = 0
        with open(self.path, "rb") as f:
            for off, comp_nb, lo, hi, dig in sorted(e.enc_chunks or (),
                                                    key=lambda c: c[2]):
                if lo != covered:
                    break
                f.seek(off)
                # the header is checked here; the digest is verified
                # while the chunk's piece is dequantized
                decoder.add(_decompress(f.read(comp_nb)), lo, hi, dig)
                covered = hi
        if covered != e.nbytes:
            # without this, a gap in the chunk list would silently hand
            # uninitialized buffer bytes to the restored tensor
            raise ValueError(
                f"{name!r}: encoded chunks cover {covered} of {e.nbytes} "
                f"raw bytes — corrupt or truncated footer")
        decoder.finish()
        return out

    def locate_corrupt_chunks(self, device: torch.device) -> List[str]:
        """Re-read every tensor chunk that carries a footer digest (raw
        ``raw_chunks`` and encoded ``enc_chunks`` alike) and return a
        human-readable locator per mismatch, e.g.
        ``"w00 raw chunk [0:16777216)"``. Empty list = every digested
        chunk verifies. Verify-time localization: when a file-level
        checksum fails, this names the flipped chunk instead of leaving a
        multi-GB haystack."""
        from .codecs import payload_digest
        from .reduction import _decompress
        bad: List[str] = []
        with open(self.path, "rb") as f:
            for name, e in sorted(self.tensors.items()):
                for lo, hi, dig in e.raw_chunks or ():
                    if dig is None:
                        continue
                    f.seek(e.offset + lo)
                    data = f.read(hi - lo)
                    if len(data) != hi - lo \
                            or payload_digest(data, device) != dig:
                        bad.append(f"{name} raw chunk [{lo}:{hi})")
                for off, comp_nb, lo, hi, dig in e.enc_chunks or ():
                    if dig is None:
                        continue
                    f.seek(off)
                    try:
                        raw = _decompress(f.read(comp_nb))
                    except Exception:  # noqa: BLE001 — any decode failure
                        bad.append(f"{name} {e.codec} chunk [{lo}:{hi})")
                        continue
                    if payload_digest(raw, device) != dig:
                        bad.append(f"{name} {e.codec} chunk [{lo}:{hi})")
        return bad

    def read_object_raw(self, name: str) -> bytes:
        """Serialized payload bytes (used by offline consolidation)."""
        e = self.objects[name]
        with open(self.path, "rb") as f:
            f.seek(e.offset)
            return f.read(e.nbytes)

    def read_object(self, name: str) -> Any:
        e = self.objects[name]
        payload = self.read_object_raw(name)
        if e.codec == "pickle":
            return pickle.loads(payload)
        if e.codec == "msgpack":
            return msgpack_lite.unpackb(payload)
        raise ValueError(f"unknown codec {e.codec}")
