"""One-pass int8 quantize and dequantize with the payload digest (port of
``repro/kernels/fused.py:quantize_checksum_int8`` and
``dequantize_checksum_int8``).

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
``fused_dequantize_checksum_ref``. Inputs are finite.

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


def quantize_checksum_plain(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """``(body, digest)`` of float32 rows ``x`` in plain PyTorch ops.

    Both divisions are tensor by tensor: PyTorch's CUDA ``div`` by a
    Python scalar multiplies by its reciprocal, which is not IEEE
    division."""
    _check_rows(x)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    x = torch.where(x.abs() < FLT_MIN, zero, x)
    amax = x.abs().amax(dim=1, keepdim=True)
    scale = amax / torch.full_like(amax, 127.0)
    scale = torch.where(scale < FLT_MIN, zero, scale)
    scale = torch.where(amax > 0, scale, torch.ones_like(amax))
    t = x / scale
    q = torch.where(torch.isnan(t), zero,
                    torch.clamp(torch.round(t), -127, 127)).to(torch.int8)
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
    if x.device.type != "cuda":
        raise ValueError(f"expected a CUDA tensor, got {x.device}")
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
    if body.device.type != "cuda":
        raise ValueError(f"expected a CUDA tensor, got {body.device}")
    body = aligned(body)
    out = torch.empty((n_rows, ROW_ELEMS), dtype=torch.float32,
                      device=body.device)
    dig = torch.zeros(1, dtype=torch.int32, device=body.device)
    DEQUANT_KERNEL.launch(body.data_ptr(), n_rows, out.data_ptr(),
                          dig.data_ptr())
    return out, dig
