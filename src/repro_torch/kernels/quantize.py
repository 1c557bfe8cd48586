"""Quantize-pack kernels: the one-pass int8 pair with the payload digest
(port of ``repro/kernels/fused.py:quantize_checksum_int8`` and
``dequantize_checksum_int8``) and the offline reducer's unfused kernels
(port of ``repro/kernels/quantize.py``: ``downcast_bf16``,
``quantize_int8``, ``dequantize_int8``; see the end of this module).

Rows of :data:`ROW_ELEMS` fp32 values, each with a symmetric scale:
``scale = amax / 127`` (``1.0`` for an all-zero row) and
``q = clip(round_half_even(x / scale), -127, 127)``. Both directions work
on the int8q payload *body*, the payload after its 8-byte header
(``core/codecs.py``)::

    f32 scales[n_rows] | i8 q[n_rows * 256]

and return the digest of the body's words at their payload positions
(word ``2 + row`` for a scale, ``2 + n_rows + 64 * row + w`` for the
little-endian packed q words); the two header words are added by the
codec. The CUDA kernels are ``ckpt_quantize_checksum_int8`` and
``ckpt_dequantize_checksum_int8`` in ``csrc/ckpt_kernels.cu``;
:func:`quantize_checksum_plain` and :func:`dequantize_checksum_plain` are
their plain PyTorch versions, the counterparts of
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

from typing import Tuple

import torch

from .build import CudaKernel
from .checksum import U32_MASK, WEIGHT_BASE, WEIGHT_MOD, aligned

#: fp32 values per quantization row (the Pallas kernel's lane width)
ROW_ELEMS = 256
#: the int8q payload header is two u32 words: n_rows, raw_nbytes
PAYLOAD_HEADER_WORDS = 2
#: the least normal float32; anything smaller in magnitude is flushed
FLT_MIN = torch.finfo(torch.float32).tiny

QUANT_KERNEL = CudaKernel("ckpt_quantize_checksum_int8")
DEQUANT_KERNEL = CudaKernel("ckpt_dequantize_checksum_int8")
DOWNCAST_BF16_KERNEL = CudaKernel("ckpt_downcast_bf16")
QUANT_INT8_KERNEL = CudaKernel("ckpt_quantize_int8")
DEQUANT_INT8_KERNEL = CudaKernel("ckpt_dequantize_int8")


def body_nbytes(n_rows: int) -> int:
    """Bytes of a payload body: one f32 scale and 256 int8 per row."""
    return n_rows * (4 + ROW_ELEMS)


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
    1-element int32 tensor on the card."""
    n_rows = _check_rows(x)
    _need_cuda(x)
    x = aligned(x.reshape(-1))
    body = torch.empty(body_nbytes(n_rows), dtype=torch.uint8,
                       device=x.device)
    dig = torch.zeros(1, dtype=torch.int32, device=x.device)
    QUANT_KERNEL.launch(x.data_ptr(), n_rows, body.data_ptr(),
                        dig.data_ptr())
    return body, dig


def dequantize_checksum_cuda(body: torch.Tensor, n_rows: int
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel; returns ``(float32 rows, digest)`` with the
    digest as a 1-element int32 tensor on the card."""
    _check_body(body, n_rows)
    _need_cuda(body)
    body = aligned(body)
    out = torch.empty((n_rows, ROW_ELEMS), dtype=torch.float32,
                      device=body.device)
    dig = torch.zeros(1, dtype=torch.int32, device=body.device)
    DEQUANT_KERNEL.launch(body.data_ptr(), n_rows, out.data_ptr(),
                          dig.data_ptr())
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


def downcast_bf16_plain(x: torch.Tensor) -> torch.Tensor:
    """float32 ``(R, C)`` -> bfloat16, round to nearest even, in int32
    arithmetic on the bits (NaNs are replaced before the add, so nothing
    overflows)."""
    _check_downcast(x)
    u = x.contiguous().view(torch.int32)
    nan = (u & 0x7FFFFFFF) > 0x7F800000
    safe = torch.where(nan, torch.zeros_like(u), u)
    r = ((safe + (0x7FFF + ((safe >> 16) & 1))) >> 16) & 0xFFFF
    r = torch.where(nan, ((u >> 16) & 0x8000) | 0x7FC0, r)
    # the 16-bit pattern into int16's range, so the cast is exact
    r = torch.where(r >= 0x8000, r - 0x10000, r)
    return r.to(torch.int16).view(torch.bfloat16)


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


def downcast_bf16_cuda(x: torch.Tensor) -> torch.Tensor:
    _check_downcast(x)
    _need_cuda(x)
    flat = aligned(x.reshape(-1))
    out = torch.empty(tuple(x.shape), dtype=torch.bfloat16, device=x.device)
    DOWNCAST_BF16_KERNEL.launch(flat.data_ptr(), flat.numel(),
                                out.data_ptr())
    return out


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
