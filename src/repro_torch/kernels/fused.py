"""One-pass XOR plus a digest (port of ``repro/kernels/fused.py``
``xor_checksum_u32`` and ``xor_fold_checksum_u32``).

* The delta-route encode: ``delta = cur ^ prev`` and the position-weighted
  digest of the delta words, from one read of both inputs. One launch takes
  the consecutive ``seg_words``-word segments of a piece, each segment
  digested on its own (CUDA entry ``ckpt_xor_checksum_u32_segments``,
  :func:`xor_checksum_segments_cuda`, what ``core/codecs.py``'s
  ``DeltaEncodePiece`` runs); ``ckpt_xor_checksum_u32``
  (:func:`xor_checksum_cuda`) is its one-segment case. The kernel writes
  :data:`MAX_GROUPS` partial sums a segment, each from one thread-block
  cluster (no atomic, no zeroed output); a segment's digest is their sum
  mod 2^32 (:func:`segment_digests`). :func:`xor_checksum_plain` and
  :func:`xor_checksum_segments_plain` are the plain versions, the
  counterparts of ``repro.kernels.ref.fused_xor_checksum_ref``; the plain
  segmented one gives one partial a segment, its digest.
* The fused chain-replay decode: ``base ^ delta`` and the digest of the
  *delta* words, verifying a stored delta while applying it. CUDA kernel
  ``ckpt_xor_fold_checksum_u32`` (a grid-stride loop with an atomic a
  block into a zeroed word); :func:`xor_fold_checksum_plain` is its plain
  version, the counterpart of
  ``repro.kernels.ref.fused_xor_fold_checksum_ref``.
  The reference's restore does not call it, nor does the port's: only
  ``ops.fused_xor_fold`` and the tests reach it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .build import CudaKernel
from .checksum import (MAX_SEGMENT_WORDS, U32_MASK, _i32, aligned,
                       checksum_plain, check_segment_words)
from .delta import check_pair

#: both entries launch the one kernel, so one count covers them
KERNEL = CudaKernel("ckpt_xor_checksum_u32")
SEGMENTS_ENTRY = "ckpt_xor_checksum_u32_segments"
FOLD_KERNEL = CudaKernel("ckpt_xor_fold_checksum_u32")
#: partial sums the kernel writes a segment (``kXorMaxGroups`` in
#: ``csrc/ckpt_kernels.cu``)
MAX_GROUPS = 32


def xor_checksum_plain(a: torch.Tensor, b: torch.Tensor
                       ) -> Tuple[torch.Tensor, int]:
    delta = torch.bitwise_xor(a, b)
    return delta, checksum_plain(delta)


def xor_checksum_segments_plain(a: torch.Tensor, b: torch.Tensor,
                                seg_words: int
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(a ^ b, partials)`` over the consecutive ``seg_words``-word
    segments (the last may be short) of two int32 word tensors:
    :func:`xor_checksum_plain` of each segment, ``partials`` an int32
    ``(n_segs, 1)`` tensor of their digests' u32 bits."""
    check_segment_words(seg_words)
    check_pair(a, b, a.device.type)
    fa, fb = a.reshape(-1), b.reshape(-1)
    parts = [xor_checksum_plain(fa[lo:lo + seg_words], fb[lo:lo + seg_words])
             for lo in range(0, fa.numel(), seg_words)]
    delta = torch.cat([d for d, _ in parts]) if parts else fa.clone()
    partials = torch.tensor([_i32(dig) for _, dig in parts],
                            dtype=torch.int32, device=a.device)
    return delta, partials.reshape(-1, 1)


def segment_digests(partials: torch.Tensor) -> np.ndarray:
    """Each segment's digest (uint32) from the partials of one of the
    segmented versions: the sum of its row mod 2^32. Reads a tensor on the
    card back first (a wait)."""
    p = partials.cpu().numpy().view(np.uint32)
    return (p.sum(axis=1, dtype=np.uint64) & U32_MASK).astype(np.uint32)


def _cuda_pair(a: torch.Tensor, b: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    check_pair(a, b, "cuda")
    return aligned(a.reshape(-1)), aligned(b.reshape(-1))


def _outputs(a: torch.Tensor, n_segs: int, out: Optional[torch.Tensor],
             dig: Optional[torch.Tensor]
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``out`` and ``dig`` checked (``a``'s words and ``n_segs`` rows of
    :data:`MAX_GROUPS` partials, contiguous int32 on ``a``'s device), or
    fresh uninitialised tensors: the kernel writes both whole."""
    if out is None:
        out = torch.empty_like(a)
    if dig is None:
        dig = torch.empty((n_segs, MAX_GROUPS), dtype=torch.int32,
                          device=a.device)
    for t, shape in ((out, a.shape), (dig, (n_segs, MAX_GROUPS))):
        if t.shape != shape or t.dtype != torch.int32 \
                or t.device != a.device or not t.is_contiguous():
            raise ValueError(
                f"expected contiguous int32{tuple(shape)} on {a.device}, "
                f"got {t.dtype}{tuple(t.shape)} on {t.device}")
    return out, dig


def xor_checksum_cuda(a: torch.Tensor, b: torch.Tensor,
                      out: Optional[torch.Tensor] = None,
                      dig: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on one segment; returns ``(delta, partials)``
    (``out`` and ``dig`` if given), ``partials`` an int32 ``(1,``
    :data:`MAX_GROUPS` ``)`` tensor on the card (:func:`segment_digests`)."""
    a, b = _cuda_pair(a, b)
    if a.numel() >= MAX_SEGMENT_WORDS:
        raise ValueError(f"xor_checksum_cuda takes fewer than 2^31 words, "
                         f"got {a.numel()}")
    out, dig = _outputs(a, 1, out, dig)
    KERNEL.launch(a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel(),
                  dig.data_ptr())
    return out, dig


def xor_checksum_segments_cuda(a: torch.Tensor, b: torch.Tensor,
                               seg_words: int,
                               out: Optional[torch.Tensor] = None,
                               dig: Optional[torch.Tensor] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch over every ``seg_words``-word segment; returns ``(a ^ b,
    partials)`` (``out`` and ``dig`` if given), ``partials`` an int32
    ``(n_segs,`` :data:`MAX_GROUPS` ``)`` tensor on the card. No words, no
    launch."""
    check_segment_words(seg_words)
    a, b = _cuda_pair(a, b)
    n = a.numel()
    out, dig = _outputs(a, -(-n // seg_words), out, dig)
    if n:
        KERNEL.launch(a.data_ptr(), b.data_ptr(), out.data_ptr(), n,
                      seg_words, dig.data_ptr(), entry=SEGMENTS_ENTRY)
    return out, dig


def xor_fold_checksum_plain(base: torch.Tensor, delta: torch.Tensor
                            ) -> Tuple[torch.Tensor, int]:
    return torch.bitwise_xor(base, delta), checksum_plain(delta)


def xor_fold_checksum_cuda(base: torch.Tensor, delta: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel; returns ``(base ^ delta, digest of delta)`` with
    the digest as a 1-element int32 tensor on the card."""
    check_pair(base, delta, "cuda")
    base, delta = aligned(base.reshape(-1)), aligned(delta.reshape(-1))
    out = torch.empty_like(base)
    dig = torch.zeros(1, dtype=torch.int32, device=base.device)
    FOLD_KERNEL.launch(base.data_ptr(), delta.data_ptr(), out.data_ptr(),
                       base.numel(), dig.data_ptr())
    return out, dig
