"""Bit-exact XOR delta of two u32 word buffers (port of
``repro/kernels/delta.py:delta_xor``).

``prev ^ delta == cur``: XOR is associative and order-insensitive, so a
differential chain folds back bit-exactly. The CUDA kernel is
``ckpt_delta_xor`` in ``csrc/ckpt_kernels.cu``; :func:`delta_xor_plain`
is its plain PyTorch version.
"""

from __future__ import annotations

import torch

from .build import CudaKernel
from .checksum import aligned

KERNEL = CudaKernel("ckpt_delta_xor")


def check_pair(a: torch.Tensor, b: torch.Tensor, device_type: str) -> None:
    if a.shape != b.shape or a.dtype != torch.int32 \
            or b.dtype != torch.int32 or a.device != b.device:
        raise ValueError(
            f"expected two int32 word tensors of one shape on one device, "
            f"got {a.dtype}{tuple(a.shape)}@{a.device} and "
            f"{b.dtype}{tuple(b.shape)}@{b.device}")
    if a.device.type != device_type:
        raise ValueError(f"expected {device_type} tensors, got {a.device}")


def delta_xor_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.bitwise_xor(a, b)


def delta_xor_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    check_pair(a, b, "cuda")
    a, b = aligned(a.reshape(-1)), aligned(b.reshape(-1))
    out = torch.empty_like(a)
    KERNEL.launch(a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel())
    return out
