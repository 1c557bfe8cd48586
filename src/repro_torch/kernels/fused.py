"""One-pass XOR plus a digest (port of ``repro/kernels/fused.py``
``xor_checksum_u32`` and ``xor_fold_checksum_u32``).

* The delta-route encode: ``delta = cur ^ prev`` and the position-weighted
  digest of the delta words, from one read of both inputs. CUDA kernel
  ``ckpt_xor_checksum_u32``; :func:`xor_checksum_plain` is its plain
  version, the counterpart of ``repro.kernels.ref.fused_xor_checksum_ref``.
* The fused chain-replay decode: ``base ^ delta`` and the digest of the
  *delta* words, verifying a stored delta while applying it. CUDA kernel
  ``ckpt_xor_fold_checksum_u32`` (the same kernel body, digesting its
  second operand); :func:`xor_fold_checksum_plain` is its plain version,
  the counterpart of ``repro.kernels.ref.fused_xor_fold_checksum_ref``.
  The reference's restore does not call it, nor does the port's: only
  ``ops.fused_xor_fold`` and the tests reach it.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .build import CudaKernel
from .checksum import aligned, checksum_plain
from .delta import check_pair

KERNEL = CudaKernel("ckpt_xor_checksum_u32")
FOLD_KERNEL = CudaKernel("ckpt_xor_fold_checksum_u32")


def xor_checksum_plain(a: torch.Tensor, b: torch.Tensor
                       ) -> Tuple[torch.Tensor, int]:
    delta = torch.bitwise_xor(a, b)
    return delta, checksum_plain(delta)


def xor_checksum_cuda(a: torch.Tensor, b: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel; returns ``(delta, digest)`` with the digest as a
    1-element int32 tensor on the card."""
    check_pair(a, b, "cuda")
    a, b = aligned(a.reshape(-1)), aligned(b.reshape(-1))
    out = torch.empty_like(a)
    dig = torch.zeros(1, dtype=torch.int32, device=a.device)
    KERNEL.launch(a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel(),
                  dig.data_ptr())
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
