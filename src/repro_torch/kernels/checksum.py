"""Position-weighted u32 integrity digest (port of ``repro/kernels/checksum.py``).

``sum_i x_i * (WEIGHT_BASE + i mod WEIGHT_MOD) mod 2^32`` over the
little-endian u32 words of a buffer (the byte tail zero-padded to a whole
word). Position weighting catches reordered blocks, which a plain sum
would miss. The CUDA kernel is ``ckpt_checksum_u32`` in
``csrc/ckpt_kernels.cu``; :func:`checksum_plain` is its plain PyTorch
version, the counterpart of ``repro.kernels.ref.checksum_np``.
"""

from __future__ import annotations

import torch

from .build import CudaKernel

WEIGHT_MOD = 65_521     # largest prime < 2^16 (adler-style)
WEIGHT_BASE = 65_599
U32_MASK = 0xFFFFFFFF

KERNEL = CudaKernel("ckpt_checksum_u32")


def as_words(data: torch.Tensor) -> torch.Tensor:
    """Flat int32 view of a tensor's bytes, zero-padding the byte tail to a
    whole u32 word (``repro.kernels.ops.as_u32``). Int32 stands in for u32:
    ``torch.uint32`` supports almost no arithmetic."""
    b = data.reshape(-1)
    if b.dtype != torch.uint8:
        b = b.view(torch.uint8)
    pad = (-b.numel()) % 4
    if pad or b.storage_offset() % 4:
        b = torch.cat([b, b.new_zeros(pad)])
    return b.view(torch.int32)


def checksum_plain(words: torch.Tensor) -> int:
    """The digest in plain PyTorch ops, on any device.

    Each product is masked to 32 bits *before* the int64 sum: a product
    is below 2^49, and summing unmasked products would overflow int64 once
    a buffer holds about 2^15 words; masked terms are below 2^32, so the
    sum stays exact for buffers up to 2^31 words."""
    n = words.numel()
    if n == 0:
        return 0
    x = words.reshape(-1).to(torch.int64) & U32_MASK
    w = torch.arange(n, dtype=torch.int64, device=words.device) \
        % WEIGHT_MOD + WEIGHT_BASE
    return int(((x * w) & U32_MASK).sum().item()) & U32_MASK


def aligned(words: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned, as the kernels' uint4 loads need."""
    if not words.is_contiguous() or words.data_ptr() % 16:
        words = words.clone(memory_format=torch.contiguous_format)
    return words


def checksum_cuda(words: torch.Tensor) -> torch.Tensor:
    """Launch the kernel; returns the digest as a 1-element int32 tensor on
    the card (read it with ``int(t.item()) & U32_MASK``)."""
    if words.device.type != "cuda" or words.dtype != torch.int32:
        raise ValueError(
            f"checksum_cuda takes int32 words on a CUDA device, got "
            f"{words.dtype} on {words.device}")
    words = aligned(words.reshape(-1))
    out = torch.zeros(1, dtype=torch.int32, device=words.device)
    KERNEL.launch(words.data_ptr(), words.numel(), out.data_ptr())
    return out
