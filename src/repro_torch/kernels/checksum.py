"""Position-weighted u32 integrity digest (port of ``repro/kernels/checksum.py``).

``sum_i x_i * (WEIGHT_BASE + i mod WEIGHT_MOD) mod 2^32`` over the
little-endian u32 words of a buffer (the byte tail zero-padded to a whole
word). Position weighting catches reordered blocks, which a plain sum
would miss. The CUDA kernel is in ``csrc/ckpt_kernels.cu``: one launch
digests the consecutive ``seg_words``-word segments of a buffer, each
segment on its own (``ckpt_checksum_u32_segments``, what
``storage/manifest.py:file_checksum`` runs on 16 chunks at a time), and
``ckpt_checksum_u32`` is its one-segment case. :func:`checksum_plain` and
:func:`checksum_segments_plain` are the plain PyTorch versions, the
counterparts of ``repro.kernels.ref.checksum_np``.
"""

from __future__ import annotations

from typing import Optional

import torch

from .build import CudaKernel

WEIGHT_MOD = 65_521     # largest prime < 2^16 (adler-style)
WEIGHT_BASE = 65_599
U32_MASK = 0xFFFFFFFF

#: both entries launch the one kernel, so one count covers them
KERNEL = CudaKernel("ckpt_checksum_u32")
SEGMENTS_ENTRY = "ckpt_checksum_u32_segments"
#: the kernel's word positions inside a segment are 32-bit
MAX_SEGMENT_WORDS = 1 << 31


def as_words(data: torch.Tensor) -> torch.Tensor:
    """Flat int32 view of a tensor's bytes, zero-padding the byte tail to a
    whole u32 word (``repro.kernels.ops.as_u32``). Int32 stands in for u32:
    ``torch.uint32`` supports almost no arithmetic."""
    b = data.reshape(-1)
    if b.numel() == 0:   # numpy's empty arrays come with stride 0
        return torch.empty(0, dtype=torch.int32, device=b.device)
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


def check_segment_words(seg_words: int) -> None:
    """A segment starts 16-byte aligned, as the kernel's loads need: its
    length is a positive multiple of 4 words, below 2^31."""
    if not 0 < seg_words < MAX_SEGMENT_WORDS or seg_words % 4:
        raise ValueError(f"seg_words must be a positive multiple of 4 below "
                         f"2^31, got {seg_words}")


def _i32(u: int) -> int:
    return u - (1 << 32) if u >= 1 << 31 else u


def checksum_segments_plain(words: torch.Tensor, seg_words: int,
                            out: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """The digest of each consecutive ``seg_words``-word segment of
    ``words`` (the last may be short), as u32 bits in an int32 tensor on
    ``words``' device: :func:`checksum_plain` of each segment."""
    check_segment_words(seg_words)
    flat = words.reshape(-1)
    digests = torch.tensor(
        [_i32(checksum_plain(flat[lo:lo + seg_words]))
         for lo in range(0, flat.numel(), seg_words)],
        dtype=torch.int32, device=words.device)
    if out is None:
        return digests
    return _digest_out(out, digests.numel(), words.device).copy_(digests)


def _cuda_words(words: torch.Tensor, what: str) -> torch.Tensor:
    if words.device.type != "cuda" or words.dtype != torch.int32:
        raise ValueError(
            f"{what} takes int32 words on a CUDA device, got "
            f"{words.dtype} on {words.device}")
    return aligned(words.reshape(-1))


def _digest_out(out: Optional[torch.Tensor], n: int,
                device: torch.device) -> torch.Tensor:
    """``out``, checked to hold ``n`` contiguous int32 digests on
    ``device``, or a fresh uninitialised tensor: the kernel writes every
    digest whole, so nothing is zeroed first."""
    if out is None:
        return torch.empty(n, dtype=torch.int32, device=device)
    if out.shape != (n,) or out.dtype != torch.int32 \
            or out.device != device or not out.is_contiguous():
        raise ValueError(
            f"out must be {n} contiguous int32 digests on {device}, got "
            f"{out.dtype}{tuple(out.shape)} on {out.device}")
    return out


def checksum_cuda(words: torch.Tensor,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the kernel on one segment; returns the digest as a 1-element
    int32 tensor on the card, ``out`` if given (read it with
    ``int(t.item()) & U32_MASK``)."""
    words = _cuda_words(words, "checksum_cuda")
    if words.numel() >= MAX_SEGMENT_WORDS:
        raise ValueError(f"checksum_cuda takes fewer than 2^31 words, got "
                         f"{words.numel()}")
    out = _digest_out(out, 1, words.device)
    KERNEL.launch(words.data_ptr(), words.numel(), out.data_ptr())
    return out


def checksum_segments_cuda(words: torch.Tensor, seg_words: int,
                           out: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """One launch over every ``seg_words``-word segment of ``words``;
    returns their digests as an int32 tensor on the card (``out`` if
    given). No words, no launch."""
    check_segment_words(seg_words)
    words = _cuda_words(words, "checksum_segments_cuda")
    n = words.numel()
    out = _digest_out(out, -(-n // seg_words), words.device)
    if n:
        KERNEL.launch(words.data_ptr(), n, seg_words, out.data_ptr(),
                      entry=SEGMENTS_ENTRY)
    return out
