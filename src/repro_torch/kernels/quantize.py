"""Quantize-pack kernels: the one-pass int8 pair with the payload digest
(port of ``repro/kernels/fused.py:quantize_checksum_int8`` and
``dequantize_checksum_int8``) and the offline reducer's unfused kernels
(port of ``repro/kernels/quantize.py``: ``downcast_bf16``,
``quantize_int8``, ``dequantize_int8``; see the end of this module).

Rows of :data:`ROW_ELEMS` fp32 values, each with a symmetric scale:
``scale = amax / 127`` (``1.0`` for an all-zero row) and
``q = clip(round_half_even(x / scale), -127, 127)``. The pair works on
int8q payloads (``core/codecs.py``)::

    u32 n_rows | u32 raw_nbytes | f32 scales[n_rows] | i8 q[n_rows * 256]

and returns the digest of a payload's words at their positions (words
0-1 the header, ``2 + row`` a scale, ``2 + n_rows + 64 * row + w`` the
little-endian packed q words).

One launch takes the consecutive chunks of a piece, each a *segment* of
whole rows given by its row starts (``row_starts[0] == 0``, at most
:data:`MAX_SEGMENTS` segments): :func:`quantize_checksum_segments_cuda`
writes the segments' payloads back to back (segment ``s`` at byte
``8 * s + 260 * row_starts[s]``, :func:`segment_offsets`) and one digest a
segment, from raw bytes of which only the first ``valid_bytes`` are data
(the rest of the last row reads as zeros);
:func:`dequantize_checksum_segments_cuda` reads that layout back into
contiguous rows. The CUDA entries are
``ckpt_quantize_checksum_int8_segments`` and
``ckpt_dequantize_checksum_int8_segments`` in ``csrc/ckpt_kernels.cu``;
``ckpt_quantize_checksum_int8`` and ``ckpt_dequantize_checksum_int8``
are their one-segment case on a payload *body* (the payload after its
8-byte header, with the header words left out of the digest), what
:func:`quantize_checksum_cuda` and :func:`dequantize_checksum_cuda`
launch. The ``*_plain`` functions are the plain PyTorch versions (the
segmented ones a loop of the body ones), the counterparts of
``repro.kernels.ref.fused_quantize_checksum_ref`` and
``fused_dequantize_checksum_ref``. As in the reference, a NaN in a row
makes its scale 1.0 (and stores 0 for the NaN), and an infinity makes
it infinite (and every q of the row 0).

The reference computes with subnormals flushed (XLA on the CPU, and the
TPU), so the quantizer flushes explicitly and agrees with it bit for bit
on any host: subnormal inputs read as zero, a scale that would be
subnormal is zero (the row's nonzero values then store ``+-127``), and a
``0 / 0`` quotient stores 0, as XLA's NaN-to-int conversion does.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from .build import CudaKernel
from .checksum import U32_MASK, WEIGHT_BASE, WEIGHT_MOD, aligned

#: fp32 values per quantization row (the Pallas kernel's lane width)
ROW_ELEMS = 256
#: the int8q payload header is two u32 words: n_rows, raw_nbytes
PAYLOAD_HEADER_WORDS = 2
PAYLOAD_HEADER_BYTES = 4 * PAYLOAD_HEADER_WORDS
#: raw fp32 bytes a row
ROW_BYTES = 4 * ROW_ELEMS
#: segments one launch takes (the kernel's table travels by value)
MAX_SEGMENTS = 32
#: rows a segment holds at most (its digest positions are 32-bit)
MAX_SEGMENT_ROWS = 1 << 25
#: the least normal float32; anything smaller in magnitude is flushed
FLT_MIN = torch.finfo(torch.float32).tiny

#: each launch count covers the one-segment entry and the segmented one
QUANT_KERNEL = CudaKernel("ckpt_quantize_checksum_int8")
DEQUANT_KERNEL = CudaKernel("ckpt_dequantize_checksum_int8")
QUANT_SEGMENTS_ENTRY = "ckpt_quantize_checksum_int8_segments"
DEQUANT_SEGMENTS_ENTRY = "ckpt_dequantize_checksum_int8_segments"
DOWNCAST_BF16_KERNEL = CudaKernel("ckpt_downcast_bf16")
QUANT_INT8_KERNEL = CudaKernel("ckpt_quantize_int8")
DEQUANT_INT8_KERNEL = CudaKernel("ckpt_dequantize_int8")


def body_nbytes(n_rows: int) -> int:
    """Bytes of a payload body: one f32 scale and 256 int8 per row."""
    return n_rows * (4 + ROW_ELEMS)


def header_digest(n_rows: int, raw_nbytes: int) -> int:
    """Digest terms of a payload's two header words (words 0 and 1)."""
    return (n_rows * WEIGHT_BASE + raw_nbytes * (WEIGHT_BASE + 1)) \
        & U32_MASK


def body_digest(body: torch.Tensor) -> int:
    """Digest of a body's words at their payload positions (from word
    :data:`PAYLOAD_HEADER_WORDS`), each product masked to 32 bits before
    the int64 sum as in :func:`.checksum.checksum_plain`."""
    x = body.view(torch.int32).to(torch.int64) & U32_MASK
    idx = torch.arange(PAYLOAD_HEADER_WORDS, PAYLOAD_HEADER_WORDS + x.numel(),
                       dtype=torch.int64, device=body.device)
    w = idx % WEIGHT_MOD + WEIGHT_BASE
    return int(((x * w) & U32_MASK).sum().item()) & U32_MASK


def _check_rows(x: torch.Tensor) -> int:
    if x.dim() != 2 or x.shape[1] != ROW_ELEMS or x.shape[0] < 1 \
            or x.dtype != torch.float32:
        raise ValueError(
            f"expected float32 rows of shape (n_rows >= 1, {ROW_ELEMS}), "
            f"got {x.dtype}{tuple(x.shape)}")
    return x.shape[0]


def _check_body(body: torch.Tensor, n_rows: int) -> None:
    if body.dtype != torch.uint8 or body.dim() != 1 or n_rows < 1 \
            or body.numel() != body_nbytes(n_rows):
        raise ValueError(
            f"expected a uint8 body of {body_nbytes(n_rows)} bytes for "
            f"{n_rows} rows, got {body.dtype}{tuple(body.shape)}")


def _quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q, scales)`` of float32 rows ``(R, 256)``: int8 ``(R, 256)`` and
    float32 ``(R, 1)``, with the reference's flushing (module docstring).

    Both divisions are tensor by tensor: PyTorch's CUDA ``div`` by a
    Python scalar multiplies by its reciprocal, which is not IEEE
    division."""
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    x = torch.where(x.abs() < FLT_MIN, zero, x)
    amax = x.abs().amax(dim=1, keepdim=True)
    scale = amax / torch.full_like(amax, 127.0)
    scale = torch.where(scale < FLT_MIN, zero, scale)
    scale = torch.where(amax > 0, scale, torch.ones_like(amax))
    t = x / scale
    q = torch.where(torch.isnan(t), zero,
                    torch.clamp(torch.round(t), -127, 127)).to(torch.int8)
    return q, scale


def _need_cuda(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"expected a CUDA tensor, got {t.device}")


def quantize_checksum_plain(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """``(body, digest)`` of float32 rows ``x`` in plain PyTorch ops."""
    _check_rows(x)
    q, scale = _quantize_rows(x)
    body = torch.cat([scale.reshape(-1).view(torch.uint8),
                      q.reshape(-1).view(torch.uint8)])
    return body, body_digest(body)


def dequantize_checksum_plain(body: torch.Tensor, n_rows: int
                              ) -> Tuple[torch.Tensor, int]:
    """``(float32 rows, digest)`` of a body in plain PyTorch ops."""
    _check_body(body, n_rows)
    scales = body[:4 * n_rows].view(torch.float32).reshape(n_rows, 1)
    q = body[4 * n_rows:].view(torch.int8).reshape(n_rows, ROW_ELEMS)
    return q.to(torch.float32) * scales, body_digest(body)


def quantize_checksum_cuda(x: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel; returns ``(body, digest)`` with the digest as a
    1-element int32 tensor on the card (the kernel writes it whole)."""
    n_rows = _check_rows(x)
    _need_cuda(x)
    _check_segment_rows(n_rows)
    x = aligned(x.reshape(-1))
    body = torch.empty(body_nbytes(n_rows), dtype=torch.uint8,
                       device=x.device)
    dig = torch.empty(1, dtype=torch.int32, device=x.device)
    QUANT_KERNEL.launch(x.data_ptr(), n_rows, body.data_ptr(),
                        dig.data_ptr())
    return body, dig


def dequantize_checksum_cuda(body: torch.Tensor, n_rows: int
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel; returns ``(float32 rows, digest)`` with the
    digest as a 1-element int32 tensor on the card."""
    _check_body(body, n_rows)
    _need_cuda(body)
    _check_segment_rows(n_rows)
    body = aligned(body)
    out = torch.empty((n_rows, ROW_ELEMS), dtype=torch.float32,
                      device=body.device)
    dig = torch.empty(1, dtype=torch.int32, device=body.device)
    DEQUANT_KERNEL.launch(body.data_ptr(), n_rows, out.data_ptr(),
                          dig.data_ptr())
    return out, dig


# ------------------------------------------------------------- segments
def _check_segment_rows(n_rows: int) -> None:
    if not 1 <= n_rows <= MAX_SEGMENT_ROWS:
        raise ValueError(f"a segment holds 1 to {MAX_SEGMENT_ROWS} rows, "
                         f"got {n_rows}")


def check_row_starts(row_starts: Sequence[int]) -> List[int]:
    """The segment table as a list: 0 first, then increasing, 1 to
    :data:`MAX_SEGMENTS` segments of 1 to :data:`MAX_SEGMENT_ROWS` rows,
    fewer than 2^31 rows in all."""
    starts = [int(r) for r in row_starts]
    if not 2 <= len(starts) <= MAX_SEGMENTS + 1 or starts[0] != 0 \
            or starts[-1] >= 1 << 31:
        raise ValueError(f"row_starts must be 0 then 1 to {MAX_SEGMENTS} "
                         f"increasing row starts, got {starts}")
    for lo, hi in zip(starts, starts[1:]):
        _check_segment_rows(hi - lo)
    return starts


def segment_offsets(row_starts: Sequence[int]) -> List[int]:
    """Byte offset of each segment's payload in the back-to-back layout,
    and the layout's end: ``8 * s + 260 * row_starts[s]``."""
    return [PAYLOAD_HEADER_BYTES * s + body_nbytes(r)
            for s, r in enumerate(row_starts)]


def _check_valid(valid_bytes: int, starts: List[int]) -> int:
    """The valid raw bytes end inside the last row, so every segment's
    row count is the codec's ``ceil(raw_nbytes / 1024)``."""
    valid = int(valid_bytes)
    if not ROW_BYTES * (starts[-1] - 1) < valid <= ROW_BYTES * starts[-1]:
        raise ValueError(
            f"valid_bytes {valid} does not end inside the last of "
            f"{starts[-1]} rows")
    return valid


def _flat_u8(t: torch.Tensor) -> torch.Tensor:
    t = t.reshape(-1)
    return t if t.dtype == torch.uint8 else t.view(torch.uint8)


def _segments_out(t: Optional[torch.Tensor], shape, dtype,
                  device: torch.device, what: str) -> torch.Tensor:
    """``t`` checked to be a contiguous ``dtype`` tensor of ``shape`` on
    ``device``, 16-byte aligned, or a fresh uninitialised one: the kernels
    write every output whole, so nothing is zeroed first."""
    if t is None:
        return torch.empty(shape, dtype=dtype, device=device)
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype \
            or t.device != device or not t.is_contiguous() \
            or (device.type == "cuda" and t.data_ptr() % 16):
        raise ValueError(
            f"{what} must be a contiguous, 16-byte aligned {dtype} tensor "
            f"of shape {tuple(shape)} on {device}, got {t.dtype}"
            f"{tuple(t.shape)} on {t.device}")
    return t


def _i32(u: int) -> int:
    return u - (1 << 32) if u >= 1 << 31 else u


def quantize_checksum_segments_plain(
        x: torch.Tensor, valid_bytes: int, row_starts: Sequence[int],
        out: Optional[torch.Tensor] = None,
        dig: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(payloads, digests)`` of the segments of raw fp32 bytes ``x``
    (any dtype, flat, holding at least ``valid_bytes``): the header, then
    :func:`quantize_checksum_plain` of the segment's rows, the bytes past
    ``valid_bytes`` read as zeros. ``digests`` is int32 holding u32 bits;
    both on ``x``'s device (into ``out`` / ``dig`` if given)."""
    starts = check_row_starts(row_starts)
    valid = _check_valid(valid_bytes, starts)
    raw = _flat_u8(x)
    if raw.numel() < valid:
        raise ValueError(f"x holds {raw.numel()} bytes, valid_bytes is "
                         f"{valid}")
    offs = segment_offsets(starts)
    out = _segments_out(out, (offs[-1],), torch.uint8, raw.device,
                        "payloads")
    digests = []
    for s, (r0, r1) in enumerate(zip(starts, starts[1:])):
        lo, hi = ROW_BYTES * r0, min(valid, ROW_BYTES * r1)
        rows = torch.zeros(ROW_BYTES * (r1 - r0), dtype=torch.uint8,
                           device=raw.device)
        rows[:hi - lo] = raw[lo:hi]
        body, area = quantize_checksum_plain(
            rows.view(torch.float32).reshape(-1, ROW_ELEMS))
        out[offs[s]:offs[s] + PAYLOAD_HEADER_BYTES] = torch.tensor(
            [r1 - r0, hi - lo], dtype=torch.int32).view(torch.uint8)
        out[offs[s] + PAYLOAD_HEADER_BYTES:offs[s + 1]] = body
        digests.append(_i32((header_digest(r1 - r0, hi - lo) + area)
                            & U32_MASK))
    d = _segments_out(dig, (len(digests),), torch.int32, raw.device,
                      "dig")
    return out, d.copy_(torch.tensor(digests, dtype=torch.int32))


def dequantize_checksum_segments_plain(
        payloads: torch.Tensor, row_starts: Sequence[int],
        out: Optional[torch.Tensor] = None,
        dig: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(float32 rows (row_starts[-1], 256), digests)`` of back-to-back
    payloads: :func:`dequantize_checksum_plain` of each body, the digest
    adding the header words as the payload holds them."""
    starts = check_row_starts(row_starts)
    offs = segment_offsets(starts)
    data = _flat_u8(payloads)
    if data.numel() != offs[-1]:
        raise ValueError(f"expected {offs[-1]} payload bytes for the "
                         f"segments {starts}, got {data.numel()}")
    out = _segments_out(out, (starts[-1], ROW_ELEMS), torch.float32,
                        data.device, "out")
    digests = []
    for s, (r0, r1) in enumerate(zip(starts, starts[1:])):
        pay = data[offs[s]:offs[s + 1]]
        if pay.storage_offset() % 4:
            pay = pay.clone()
        n_rows, raw_nbytes = (int(v) for v in
                              pay[:PAYLOAD_HEADER_BYTES].cpu().numpy()
                              .view("<u4"))
        rows, area = dequantize_checksum_plain(pay[PAYLOAD_HEADER_BYTES:],
                                               r1 - r0)
        out[r0:r1] = rows
        digests.append(_i32((header_digest(n_rows, raw_nbytes) + area)
                            & U32_MASK))
    d = _segments_out(dig, (len(digests),), torch.int32, data.device,
                      "dig")
    return out, d.copy_(torch.tensor(digests, dtype=torch.int32))


def _starts_arg(starts: List[int]) -> ctypes.Array:
    """The segment table as the host i64 array the C entry reads."""
    return (ctypes.c_int64 * len(starts))(*starts)


def quantize_checksum_segments_cuda(
        x: torch.Tensor, valid_bytes: int, row_starts: Sequence[int],
        out: Optional[torch.Tensor] = None,
        dig: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch over the segments; returns ``(payloads, digests)`` on the
    card (``out`` / ``dig`` if given). It only enqueues: nothing waits."""
    starts = check_row_starts(row_starts)
    valid = _check_valid(valid_bytes, starts)
    _need_cuda(x)
    raw = _flat_u8(x)
    if raw.numel() < valid:
        raise ValueError(f"x holds {raw.numel()} bytes, valid_bytes is "
                         f"{valid}")
    raw = aligned(raw)
    offs = segment_offsets(starts)
    out = _segments_out(out, (offs[-1],), torch.uint8, raw.device,
                        "payloads")
    dig = _segments_out(dig, (len(starts) - 1,), torch.int32, raw.device,
                        "dig")
    QUANT_KERNEL.launch(raw.data_ptr(), valid, _starts_arg(starts),
                        len(starts) - 1, out.data_ptr(), dig.data_ptr(),
                        entry=QUANT_SEGMENTS_ENTRY)
    return out, dig


def dequantize_checksum_segments_cuda(
        payloads: torch.Tensor, row_starts: Sequence[int],
        out: Optional[torch.Tensor] = None,
        dig: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch over the segments' payloads; returns ``(float32 rows,
    digests)`` on the card. The headers are the caller's to check (the
    codec does, before the upload). It only enqueues."""
    starts = check_row_starts(row_starts)
    _need_cuda(payloads)
    offs = segment_offsets(starts)
    data = aligned(_flat_u8(payloads))
    if data.numel() != offs[-1]:
        raise ValueError(f"expected {offs[-1]} payload bytes for the "
                         f"segments {starts}, got {data.numel()}")
    out = _segments_out(out, (starts[-1], ROW_ELEMS), torch.float32,
                        data.device, "out")
    dig = _segments_out(dig, (len(starts) - 1,), torch.int32, data.device,
                        "dig")
    DEQUANT_KERNEL.launch(data.data_ptr(), _starts_arg(starts),
                          len(starts) - 1, out.data_ptr(), dig.data_ptr(),
                          entry=DEQUANT_SEGMENTS_ENTRY)
    return out, dig


# ------------------------------------------------------ offline reduction
# The unfused kernels of ``repro/kernels/quantize.py``, reached from the
# offline reducer's encode (``core/reduction.py``). They keep the Pallas
# kernels' tiling as their shape contract: rows (and, for the downcast,
# columns) a multiple of :data:`TILE`, and exactly :data:`ROW_ELEMS`
# columns for the int8 pair; any other shape raises ``ValueError`` where
# the reference asserts. The CUDA kernels are ``ckpt_downcast_bf16``,
# ``ckpt_quantize_int8`` and ``ckpt_dequantize_int8`` in
# ``csrc/ckpt_kernels.cu``; the ``*_plain`` functions are their plain
# versions.
#
# What the reference computes at the edges (its Pallas kernels, run by
# XLA on the CPU as on the TPU):
#
# * the downcast rounds to nearest even and keeps subnormals; every NaN
#   becomes its sign bit OR ``0x7fc0``. ``Tensor.to(torch.bfloat16)``
#   gives other NaN bits (``0xffff`` on the CPU, ``0x7fff`` on a card),
#   so the plain version rounds in integer arithmetic;
# * ``quantize_int8`` is :func:`_quantize_rows`, the fused encode's math;
# * ``dequantize_int8`` flushes subnormal scales and products to a zero
#   of the same sign (``-1 * 1e-38`` gives ``-0.0``).

#: the Pallas kernels' tile edge: rows (and downcast columns) divide by it
TILE = 256
#: fp32 bit patterns the reduction kernels must treat as the reference
#: does: NaNs (quiet, signalling, with payload, both signs), +-inf, the
#: largest floats, rounding ties of the bf16 downcast, subnormals of both
#: signs, the least normal float, signed zeros
EDGE_BITS = (0x7FC00000, 0xFFC00000, 0x7F800001, 0x7FA00000, 0xFF800001,
             0x7FFFFFFF, 0x7F800000, 0xFF800000, 0x7F7FFFFF, 0xFF7FFFFF,
             0x3F808000, 0x3F818000, 0x3F80FFFF, 0x7F7F8000, 0x00000001,
             0x80000001, 0x000116C2, 0x007FFFFF, 0x00800000, 0x80800000,
             0x00008000, 0x00018000, 0x00000000, 0x80000000)


def edge_values(device) -> torch.Tensor:
    """:data:`EDGE_BITS` as a float32 tensor on ``device``."""
    return torch.tensor([b - (1 << 32) if b >= 1 << 31 else b
                         for b in EDGE_BITS], dtype=torch.int32) \
        .view(torch.float32).to(device)


def flush_subnormals(v: torch.Tensor) -> torch.Tensor:
    """``v`` with every subnormal replaced by a zero of its sign, as XLA
    computes on the CPU and the TPU."""
    return torch.where(v.abs() < FLT_MIN,
                       torch.copysign(torch.zeros_like(v), v), v)


def _check_downcast(x: torch.Tensor) -> None:
    if x.dtype != torch.float32 or x.dim() != 2 \
            or x.shape[0] % TILE or x.shape[1] % TILE:
        raise ValueError(
            f"downcast_bf16 takes float32 (R, C) with R and C multiples of "
            f"{TILE}, got {x.dtype}{tuple(x.shape)}")


def _check_flat_f32(x: torch.Tensor) -> None:
    if x.dtype != torch.float32 or x.dim() != 1:
        raise ValueError(f"expected flat float32, got {x.dtype}"
                         f"{tuple(x.shape)}")


def _check_quantize(x: torch.Tensor) -> None:
    if x.dtype != torch.float32 or x.dim() != 2 \
            or x.shape[0] % TILE or x.shape[1] != ROW_ELEMS:
        raise ValueError(
            f"quantize_int8 takes float32 (R, {ROW_ELEMS}) with R a "
            f"multiple of {TILE}, got {x.dtype}{tuple(x.shape)}")


def _check_dequantize(q: torch.Tensor, scales: torch.Tensor) -> None:
    if q.dtype != torch.int8 or q.dim() != 2 or q.shape[0] % TILE \
            or q.shape[1] != ROW_ELEMS or scales.dtype != torch.float32 \
            or tuple(scales.shape) != (q.shape[0], 1) \
            or scales.device != q.device:
        raise ValueError(
            f"dequantize_int8 takes int8 q (R, {ROW_ELEMS}) with R a "
            f"multiple of {TILE} and float32 scales (R, 1) on q's device, "
            f"got {q.dtype}{tuple(q.shape)}@{q.device} and "
            f"{scales.dtype}{tuple(scales.shape)}@{scales.device}")


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    """float32 -> bfloat16 of any shape, round to nearest even, in int32
    arithmetic on the bits (NaNs are replaced before the add, so nothing
    overflows)."""
    u = x.contiguous().view(torch.int32)
    nan = (u & 0x7FFFFFFF) > 0x7F800000
    safe = torch.where(nan, torch.zeros_like(u), u)
    r = ((safe + (0x7FFF + ((safe >> 16) & 1))) >> 16) & 0xFFFF
    r = torch.where(nan, ((u >> 16) & 0x8000) | 0x7FC0, r)
    # the 16-bit pattern into int16's range, so the cast is exact
    r = torch.where(r >= 0x8000, r - 0x10000, r)
    return r.to(torch.int16).view(torch.bfloat16)


def downcast_bf16_plain(x: torch.Tensor) -> torch.Tensor:
    """float32 ``(R, C)`` -> bfloat16, as :func:`_round_bf16`."""
    _check_downcast(x)
    return _round_bf16(x)


def downcast_bf16_words_plain(x: torch.Tensor) -> torch.Tensor:
    """Flat float32 of any length -> flat bfloat16: the plain version of
    :func:`downcast_bf16_words_cuda`."""
    _check_flat_f32(x)
    return _round_bf16(x.reshape(-1))


def quantize_int8_plain(x: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 ``(R, 256)`` -> ``(q int8 (R, 256), scales float32 (R, 1))``."""
    _check_quantize(x)
    return _quantize_rows(x)


def dequantize_int8_plain(q: torch.Tensor, scales: torch.Tensor
                          ) -> torch.Tensor:
    """``q * scales`` in float32, subnormals flushed in and out."""
    _check_dequantize(q, scales)
    return flush_subnormals(q.to(torch.float32) * flush_subnormals(scales))


def downcast_bf16_words_cuda(x: torch.Tensor) -> torch.Tensor:
    """The kernel on a flat float32 tensor of any length. The shape
    contract of :func:`downcast_bf16_cuda` gives lengths that are
    multiples of 65,536, so the kernel's partial last tile and trailing
    words are checked through this entry."""
    _check_flat_f32(x)
    _need_cuda(x)
    flat = aligned(x.reshape(-1))
    out = torch.empty(flat.numel(), dtype=torch.bfloat16, device=x.device)
    DOWNCAST_BF16_KERNEL.launch(flat.data_ptr(), flat.numel(),
                                out.data_ptr())
    return out


def downcast_bf16_cuda(x: torch.Tensor) -> torch.Tensor:
    _check_downcast(x)
    return downcast_bf16_words_cuda(x.reshape(-1)).view(tuple(x.shape))


def quantize_int8_cuda(x: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    _check_quantize(x)
    _need_cuda(x)
    n_rows = x.shape[0]
    flat = aligned(x.reshape(-1))
    q = torch.empty((n_rows, ROW_ELEMS), dtype=torch.int8, device=x.device)
    scales = torch.empty((n_rows, 1), dtype=torch.float32, device=x.device)
    QUANT_INT8_KERNEL.launch(flat.data_ptr(), n_rows, q.data_ptr(),
                             scales.data_ptr())
    return q, scales


def dequantize_int8_cuda(q: torch.Tensor, scales: torch.Tensor
                         ) -> torch.Tensor:
    _check_dequantize(q, scales)
    _need_cuda(q)
    n_rows = q.shape[0]
    qf = aligned(q.reshape(-1))
    sf = scales.reshape(-1).contiguous()
    out = torch.empty((n_rows, ROW_ELEMS), dtype=torch.float32,
                      device=q.device)
    DEQUANT_INT8_KERNEL.launch(qf.data_ptr(), sf.data_ptr(), n_rows,
                               out.data_ptr())
    return out
