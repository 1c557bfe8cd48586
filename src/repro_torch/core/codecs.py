"""Tensor chunk codecs for encoded (non-raw) checkpoint payloads (port of
``repro/core/codecs.py``).

The engine's flush lanes treat any chunk with ``codec != "raw"`` the same
way: compress the producer-encoded payload and log-append it with explicit
raw-range addressing (``layout.FileWriter.append_encoded_chunk``). What
differs per codec is whether decoding is *self-contained* or *chained*:

* **chained** codecs (``xor+zstd``, differential checkpointing) encode a
  chunk relative to a previous checkpoint's bytes; their payloads only
  have meaning during chain replay (``RestoreEngine.restore_chain``).
* **self-contained** codecs (``int8q+zstd``, per-row int8 quantization of
  fp32 state) decode standalone, so a quantized tensor restores like any
  raw tensor, selective per-domain restores included.

Encode is one pass: each encoder returns ``(payload, digest)`` from one
kernel launch on the caller's device (the fused XOR+digest or
quantize+digest kernel on a card, their plain versions on the CPU); the
digest is the position-weighted u32 checksum of the uncompressed payload,
stored per chunk in the file footer and re-verified on decode.

``int8q`` payload layout (before the flush lane's compression), covering
raw fp32 bytes ``[raw_lo, raw_hi)`` of the tensor::

    u32 n_rows | u32 raw_nbytes | f32 scales[n_rows] | i8 q[n_rows * 256]

The raw bytes are viewed as fp32, zero-padded to whole rows of 256, and
each row gets a symmetric scale ``max|x| / 127``. Decode dequantizes and
truncates the pad.

The int8 pair runs a *piece* at a time: up to :data:`PIECE_CHUNKS`
consecutive chunks of one tensor (:data:`PIECE_BYTES` of raw bytes) in
one upload, one launch and one read-back (:class:`Int8EncodePiece`,
:class:`Int8Decoder`); on a card each piece's copies and launch are only
enqueued, so the caller prepares the next piece while the card works.
:func:`encode_int8_block` and :func:`decode_int8_block` are the
one-chunk case of the same code. The delta encode runs pieces too
(:class:`DeltaEncodePiece`: the chunks and their chain base uploaded,
one launch, the deltas and digests read back), sized by its caller to
the encode budget, since a delta payload is as large as its raw bytes;
:func:`encode_delta_chunk` is the reference's one-chunk call.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Type

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.checksum import as_words
from repro_torch.kernels.fused import segment_digests
from repro_torch.kernels.quantize import (MAX_SEGMENT_ROWS, ROW_ELEMS,
                                          body_nbytes, segment_offsets)

#: fp32 elements per quantization row (the kernel's row width).
INT8_ROW_ELEMS = ROW_ELEMS
#: raw bytes per quantization row.
INT8_ROW_BYTES = INT8_ROW_ELEMS * 4

_INT8_HEADER = struct.Struct("<II")

DELTA_CODEC = "xor+zstd"
INT8_CODEC = "int8q+zstd"

#: a piece of the int8 pair: at most this many chunks, and this many raw
#: bytes (a larger chunk alone)
PIECE_CHUNKS = 16
PIECE_BYTES = 64 << 20


class CodecError(ValueError):
    """A payload failed to decode (corrupt, truncated, or wrong codec)."""


def codec_base(codec: str) -> str:
    """``"int8q+zstd"`` -> ``"int8q"`` (strip the host-compression suffix)."""
    return codec.split("+", 1)[0]


def is_chained_codec(codec: str) -> bool:
    """True for codecs whose payloads only decode relative to a chain base
    (differential XOR deltas); such tensors cannot restore standalone."""
    return codec != "raw" and codec_base(codec) == "xor"


# ------------------------------------------------------------ chunk digests

def payload_digest(payload, device: torch.device) -> int:
    """Position-weighted u32 digest of an uncompressed payload's bytes,
    computed on ``device``."""
    return ops.host_checksum(payload, device)


def int8_encoded_nbytes(raw_nbytes: int) -> int:
    """Exact ``int8q`` payload size for a chunk of ``raw_nbytes``, known
    before encoding, so the encode budget can reserve it up front."""
    n_rows = -(-raw_nbytes // INT8_ROW_BYTES)
    return _INT8_HEADER.size + body_nbytes(n_rows)


def piece_groups(spans: Sequence[Tuple[int, int]],
                 max_chunks: int = PIECE_CHUNKS,
                 max_bytes: int = PIECE_BYTES
                 ) -> Iterator[List[Tuple[int, int]]]:
    """Consecutive chunks ``(lo, hi)`` grouped into pieces of at most
    ``max_chunks`` chunks and ``max_bytes`` raw bytes (a larger chunk
    alone)."""
    piece: List[Tuple[int, int]] = []
    for lo, hi in spans:
        if piece and (len(piece) == max_chunks
                      or hi - piece[0][0] > max_bytes):
            yield piece
            piece = []
        piece.append((lo, hi))
    if piece:
        yield piece


# --------------------------------------------------------------------- int8q

class Int8EncodePiece:
    """The ``int8q`` payloads and digests of consecutive chunks of one
    tensor, from one launch on ``device``.

    ``raw`` is a flat uint8 host tensor holding the piece's raw fp32 bytes
    (pinned on a card, so the upload is asynchronous); ``ends`` are the
    chunks' ends in it, every one but the last on a row boundary. On a
    card the constructor only enqueues, on the current stream, the upload,
    the launch and the read-back of payloads and digests into pinned
    memory, and records an event; :meth:`result` waits for it. ``raw`` is
    read until then, so its owner keeps it until :meth:`wait`. On the CPU
    the plain version runs at once."""

    def __init__(self, raw: torch.Tensor, ends: Sequence[int],
                 device: torch.device):
        device = torch.device(device)
        valid = int(ends[-1])
        if valid < 1 or any(e % INT8_ROW_BYTES for e in ends[:-1]):
            raise ValueError(f"int8 chunk ends {list(ends)}: every chunk "
                             f"but the last must end on a row boundary")
        starts = [0, *(e // INT8_ROW_BYTES for e in ends[:-1]),
                  -(-valid // INT8_ROW_BYTES)]
        self.offsets = segment_offsets(starts)
        self.done: Optional[torch.cuda.Event] = None
        self._raw: Optional[torch.Tensor] = None
        if device.type != "cuda":
            self.payloads, self.digests = ops.fused_quantize_int8_segments(
                raw, valid, starts)
            return
        x = torch.empty(valid, dtype=torch.uint8, device=device)
        x.copy_(raw[:valid], non_blocking=True)
        payloads, digests = ops.fused_quantize_int8_segments(x, valid,
                                                             starts)
        self.payloads = torch.empty(payloads.numel(), dtype=torch.uint8,
                                    pin_memory=True)
        self.payloads.copy_(payloads, non_blocking=True)
        self.digests = torch.empty(digests.numel(), dtype=torch.int32,
                                   pin_memory=True)
        self.digests.copy_(digests, non_blocking=True)
        self.done = torch.cuda.Event()
        self.done.record()
        self._raw = raw

    def wait(self) -> None:
        """Block until the piece's device work is done (a no-op on the
        CPU); ``raw`` is free after it."""
        if self.done is not None:
            self.done.synchronize()
            self.done = None
        self._raw = None

    def result(self) -> List[Tuple[np.ndarray, int]]:
        """``(payload, digest)`` of each chunk, once the piece is done: the
        payloads are views of one buffer (pinned on a card), which lives
        as long as any of them."""
        self.wait()
        buf = self.payloads.numpy()
        digs = self.digests.numpy().view(np.uint32)
        offs = self.offsets
        return [(buf[a:b], int(d)) for a, b, d in zip(offs, offs[1:], digs)]


def encode_int8_block(raw, with_digest: bool, device: torch.device
                      ) -> Tuple[np.ndarray, Optional[int]]:
    """Quantize one chunk of raw fp32 bytes into an ``int8q`` payload on
    ``device``: ``(payload as a uint8 array, digest|None)`` from one pass,
    the one-chunk case of :class:`Int8EncodePiece`. ``raw`` need not be a
    whole number of rows (a tensor's tail); the pad reads as zeros, which
    quantize exactly and which decode truncates."""
    raw = ops.host_u8(raw)
    if raw.size == 0:
        raise ValueError("an int8q chunk holds at least one raw byte")
    piece = Int8EncodePiece(ops.bytes_on(raw, torch.device("cpu")),
                            [raw.size], device)
    (payload, digest), = piece.result()
    return payload, digest if with_digest else None


def _check_int8_header(data: np.ndarray, raw_lo: int, raw_hi: int) -> int:
    """The row count of an ``int8q`` payload whose header agrees with its
    chunk's addressing and its own size; :class:`CodecError` otherwise."""
    if data.size < _INT8_HEADER.size:
        raise CodecError("int8q payload shorter than its header")
    n_rows, raw_nbytes = _INT8_HEADER.unpack_from(data)
    if raw_nbytes != raw_hi - raw_lo:
        raise CodecError(
            f"int8q payload declares {raw_nbytes} raw bytes, chunk "
            f"addressing says [{raw_lo}:{raw_hi}) — corrupt payload")
    want = _INT8_HEADER.size + body_nbytes(n_rows)
    if data.size != want or n_rows < 1:
        raise CodecError(
            f"int8q payload is {data.size} B, expected {want} B for "
            f"{n_rows} rows — truncated or corrupt")
    if n_rows * INT8_ROW_BYTES < raw_nbytes or n_rows > MAX_SEGMENT_ROWS:
        raise CodecError(
            f"int8q payload of {n_rows} rows cannot hold {raw_nbytes} raw "
            f"bytes — corrupt payload")
    return n_rows


class Int8Decoder:
    """Decodes a tensor's ``int8q`` chunks on ``device`` into ``out``, a
    uint8 host array whose index 0 is raw byte ``base``.

    :meth:`add` takes the chunks in raw order, each right after the
    previous one, checks each header at once (:class:`CodecError`, as the
    reference does) and gathers them into pieces (:func:`piece_groups`' bounds;
    a chunk that is not a whole number of rows ends its piece, so a
    piece's rows are its raw bytes in order). Each piece is copied into one
    buffer (pinned on a card), uploaded, decoded by one launch, and its
    rows and digests read back; on a card that is only enqueued, with at
    most two pieces in flight, so the caller decompresses the next piece
    while the card decodes this one. A piece is finished (its digests
    verified against the footer's records, its rows copied into ``out``)
    when a third is launched, or by :meth:`finish`."""

    def __init__(self, out: np.ndarray, device: torch.device, base: int = 0):
        self.out, self.base = out, base
        self.device = torch.device(device)
        self._batch: List[Tuple[np.ndarray, int, int, int, Optional[int]]] = []
        self._inflight: List[tuple] = []

    def add(self, payload, raw_lo: int, raw_hi: int,
            expect_digest: Optional[int]) -> None:
        data = ops.host_u8(payload)
        n_rows = _check_int8_header(data, raw_lo, raw_hi)
        if self._batch and (len(self._batch) == PIECE_CHUNKS
                            or raw_hi - self._batch[0][1] > PIECE_BYTES):
            self._launch()
        self._batch.append((data, raw_lo, raw_hi, n_rows, expect_digest))
        if raw_hi - raw_lo != n_rows * INT8_ROW_BYTES:
            self._launch()

    def finish(self) -> None:
        """Decode what is left, then verify and copy every piece."""
        if self._batch:
            self._launch()
        while self._inflight:
            self._complete(self._inflight.pop(0))

    def _launch(self) -> None:
        batch, self._batch = self._batch, []
        if len(self._inflight) == 2:
            self._complete(self._inflight.pop(0))
        starts = [0]
        for _d, _lo, _hi, n_rows, _dig in batch:
            starts.append(starts[-1] + n_rows)
        offs = segment_offsets(starts)
        on_card = self.device.type == "cuda"
        host = torch.empty(offs[-1], dtype=torch.uint8, pin_memory=on_card)
        view = host.numpy()
        for (data, *_rest), a, b in zip(batch, offs, offs[1:]):
            view[a:b] = data
        if not on_card:
            rows, digs = ops.fused_dequantize_int8_segments(host, starts)
            self._inflight.append((batch, rows, digs, None))
            return
        dev = torch.empty(offs[-1], dtype=torch.uint8, device=self.device)
        dev.copy_(host, non_blocking=True)
        rows, digs = ops.fused_dequantize_int8_segments(dev, starts)
        rows_h = torch.empty(rows.shape, dtype=torch.float32,
                             pin_memory=True)
        rows_h.copy_(rows, non_blocking=True)
        digs_h = torch.empty(digs.shape, dtype=torch.int32, pin_memory=True)
        digs_h.copy_(digs, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        self._inflight.append((batch, rows_h, digs_h, done))

    def _complete(self, piece: tuple) -> None:
        batch, rows, digs, done = piece
        if done is not None:
            done.synchronize()
        for (_d, lo, hi, _n, want), got in zip(
                batch, digs.numpy().view(np.uint32)):
            if want is not None and int(got) != want:
                raise CodecError(
                    f"int8q payload digest mismatch: stored {want:#010x}, "
                    f"decoded {int(got):#010x} — corrupt chunk [{lo}:{hi})")
        lo, hi = batch[0][1], batch[-1][2]
        self.out[lo - self.base:hi - self.base] = \
            rows.numpy().reshape(-1).view(np.uint8)[:hi - lo]


def decode_int8_block(payload, raw_lo: int, raw_hi: int, expect_digest,
                      device: torch.device) -> np.ndarray:
    """Inverse of :func:`encode_int8_block` on ``device``: the dequantized
    raw bytes of ``[raw_lo, raw_hi)`` as a uint8 array. Each value is
    within half a quantization step (``row max|x| / 127``) of the
    original. With ``expect_digest`` the payload is verified in the same
    pass and a mismatch raises :class:`CodecError`. The one-chunk case of
    :class:`Int8Decoder`."""
    return decode_chunk_payload(INT8_CODEC, payload, raw_lo, raw_hi,
                                expect_digest, device)


# --------------------------------------------------------------------- delta

class DeltaEncodePiece:
    """The XOR deltas of consecutive chunks of one tensor against their
    chain base, and each chunk's digest, from one launch on ``device``.

    ``cur`` and ``prev`` are flat uint8 host tensors of one length, the
    piece's staged bytes and its base (pinned on a card, so the uploads
    are asynchronous), cut into chunks of ``chunk_bytes`` (the last may be
    short). A piece of more than one chunk needs ``chunk_bytes`` a
    multiple of 16, so that every chunk is a whole segment of 16-byte
    vectors. With ``with_digest`` the fused XOR digest runs
    (``xor_checksum_segments``), else ``delta_xor``. On a card the
    constructor only enqueues, on the current stream, the two uploads, the
    launch and the read-back of the deltas and the digests' partials into
    pinned memory, and records an event; :meth:`result` waits for it.
    ``cur`` and ``prev`` are read until then, so their owner keeps them,
    and leaves ``prev`` unchanged, until :meth:`wait`. On the CPU the
    plain version runs at once."""

    def __init__(self, cur: torch.Tensor, prev: torch.Tensor,
                 chunk_bytes: int, with_digest: bool,
                 device: torch.device):
        device = torch.device(device)
        nb = int(cur.numel())
        if nb < 1 or prev.numel() != nb:
            raise ValueError(f"a delta piece of {nb} bytes against a base "
                             f"of {prev.numel()}")
        self.ends = list(range(chunk_bytes, nb, chunk_bytes)) + [nb]
        if len(self.ends) > 1 and chunk_bytes % 16:
            raise ValueError(f"chunks of {chunk_bytes} bytes are not whole "
                             f"16-byte vectors: one chunk a piece")
        # one segment a chunk; a lone chunk is one segment of any length
        self._seg_words = chunk_bytes // 4 if len(self.ends) > 1 \
            else -(-nb // 16) * 4
        self._with_digest = with_digest
        self.done: Optional[torch.cuda.Event] = None
        self.partials: Optional[torch.Tensor] = None
        if device.type != "cuda":
            delta, self.partials = self._launch(as_words(cur), as_words(prev))
            self.delta = delta.view(torch.uint8)[:nb]
            return
        n_words = -(-nb // 4)
        a, b = (torch.empty(4 * n_words, dtype=torch.uint8, device=device)
                for _ in range(2))
        a[:nb].copy_(cur, non_blocking=True)
        b[:nb].copy_(prev, non_blocking=True)
        if nb % 4:
            # the byte tail reads as zeros, as in the plain version
            a[nb:].zero_()
            b[nb:].zero_()
        delta, partials = self._launch(a.view(torch.int32),
                                       b.view(torch.int32))
        self.delta = torch.empty(nb, dtype=torch.uint8, pin_memory=True)
        self.delta.copy_(delta.view(torch.uint8)[:nb], non_blocking=True)
        if partials is not None:
            self.partials = torch.empty(partials.shape, dtype=torch.int32,
                                        pin_memory=True)
            self.partials.copy_(partials, non_blocking=True)
        self.done = torch.cuda.Event()
        self.done.record()

    def _launch(self, a: torch.Tensor, b: torch.Tensor
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        if self._with_digest:
            return ops.xor_checksum_segments(a, b, self._seg_words)
        return ops.delta_xor(a, b), None

    def wait(self) -> None:
        """Block until the piece's device work is done (a no-op on the
        CPU); ``cur`` and ``prev`` are free after it."""
        if self.done is not None:
            self.done.synchronize()
            self.done = None

    def result(self) -> List[Tuple[np.ndarray, Optional[int]]]:
        """``(delta, digest|None)`` of each chunk, once the piece is done:
        the deltas are views of one buffer (pinned on a card), which lives
        as long as any of them."""
        self.wait()
        buf = self.delta.numpy()
        digs = [None] * len(self.ends) if self.partials is None \
            else [int(d) for d in segment_digests(self.partials)]
        return [(buf[lo:hi], d)
                for lo, hi, d in zip([0, *self.ends], self.ends, digs)]


def encode_delta_chunk(cur: np.ndarray, prev: np.ndarray,
                       with_digest: bool, device: torch.device
                       ) -> Tuple[np.ndarray, Optional[int]]:
    """XOR-delta one chunk: ``(delta_bytes_u8, digest|None)`` in one pass
    over ``cur`` on ``device``, blocking (the delta provider encodes
    pieces with :class:`DeltaEncodePiece` instead)."""
    if with_digest:
        return ops.host_xor_checksum(cur, prev, device)
    return ops.host_delta_xor(cur, prev, device), None


# ------------------------------------------------------------------ registry

#: self-contained decoders: codec base -> decoder class, constructed as
#: ``cls(out, device, base)``, fed ``add(payload, raw_lo, raw_hi,
#: expect_digest)`` in raw order and closed by ``finish()``.
_DECODERS: Dict[str, Type[Int8Decoder]] = {
    "int8q": Int8Decoder,
}


def tensor_decoder(codec: str, out: np.ndarray, device: torch.device,
                   base: int = 0) -> Int8Decoder:
    """The decoder of a self-contained codec, writing raw bytes into
    ``out`` (index 0 is raw byte ``base``) on ``device``. Chained codecs go
    through chain replay instead."""
    if is_chained_codec(codec):
        raise CodecError(
            f"codec {codec!r} is chained (differential) — its payloads "
            f"only decode during chain replay, not standalone")
    cls = _DECODERS.get(codec_base(codec))
    if cls is None:
        raise CodecError(f"unknown tensor chunk codec {codec!r}")
    return cls(out, device, base)


def decode_chunk_payload(codec: str, payload, raw_lo: int, raw_hi: int,
                         expect_digest, device: torch.device) -> np.ndarray:
    """Decode one decompressed self-contained payload back to raw bytes on
    ``device``: the one-chunk case of :func:`tensor_decoder`.
    ``expect_digest`` (the footer's per-chunk record) makes the decode
    verify the payload."""
    out = np.empty(max(raw_hi - raw_lo, 0), dtype=np.uint8)
    dec = tensor_decoder(codec, out, device, base=raw_lo)
    dec.add(payload, raw_lo, raw_hi, expect_digest)
    dec.finish()
    return out
