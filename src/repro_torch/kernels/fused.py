"""One-pass XOR delta plus its digest (port of
``repro/kernels/fused.py:xor_checksum_u32``).

The delta-route encode: ``delta = cur ^ prev`` and the position-weighted
digest of the delta words, from one read of both inputs. The CUDA kernel
is ``ckpt_xor_checksum_u32`` in ``csrc/ckpt_kernels.cu``;
:func:`xor_checksum_plain` is its plain PyTorch version, the counterpart
of ``repro.kernels.ref.fused_xor_checksum_ref``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .build import CudaKernel
from .checksum import aligned, checksum_plain
from .delta import check_pair

KERNEL = CudaKernel("ckpt_xor_checksum_u32")


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
