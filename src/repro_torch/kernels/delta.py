"""Differential kernels (port of ``repro/kernels/delta.py``).

* ``delta_xor``: bit-exact XOR of two u32 word buffers. ``prev ^ delta ==
  cur``: XOR is associative and order-insensitive, so a differential chain
  folds back bit-exactly. CUDA kernel ``ckpt_delta_xor``.
* ``delta_f32``: ``cur - prev`` of two float32 buffers, computed as the
  reference computes it on the CPU and the TPU: subnormal inputs and
  results become zeros of their sign (``1.2e-38 - 1.5e-38`` gives
  ``-0.0``; ``torch.sub`` would keep ``-3e-39``). CUDA kernel
  ``ckpt_delta_f32``.

Both kernels are in ``csrc/ckpt_kernels.cu``; the ``*_plain`` functions
are their plain PyTorch versions.
"""

from __future__ import annotations

import torch

from .build import CudaKernel
from .checksum import aligned
from .quantize import flush_subnormals

KERNEL = CudaKernel("ckpt_delta_xor")
F32_KERNEL = CudaKernel("ckpt_delta_f32")


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


def check_f32_pair(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.shape != b.shape or a.dtype != torch.float32 \
            or b.dtype != torch.float32 or a.device != b.device:
        raise ValueError(
            f"expected two float32 tensors of one shape on one device, "
            f"got {a.dtype}{tuple(a.shape)}@{a.device} and "
            f"{b.dtype}{tuple(b.shape)}@{b.device}")


def delta_f32_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Flat ``a - b`` with subnormals flushed in and out."""
    check_f32_pair(a, b)
    return flush_subnormals(flush_subnormals(a.reshape(-1))
                            - flush_subnormals(b.reshape(-1)))


def delta_f32_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    check_f32_pair(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"expected cuda tensors, got {a.device}")
    a, b = aligned(a.reshape(-1)), aligned(b.reshape(-1))
    out = torch.empty_like(a)
    F32_KERNEL.launch(a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel())
    return out
