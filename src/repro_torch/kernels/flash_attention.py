"""Causal online-softmax attention (port of
``repro/kernels/flash_attention.py:flash_attention_bh``).

Layouts are the JAX package's: q ``(B, S, H, hd)``, k and v
``(B, T, KV, hd)`` with ``H % KV == 0`` (query head ``h`` reads KV head
``h // (H // KV)``), output ``(B, S, H * hd)`` in q's dtype. Query ``i``
sees key ``j`` when ``j <= i`` and, for ``kind="window"``,
``j > i - window``, or, for ``kind="chunked"``, ``i // chunk ==
j // chunk``; or, with ``n_prefix``, when both lie below ``n_prefix``
(the prefix-LM's patch prefix attends both ways). This is
``repro.models.layers._allowed``. The TPU kernel takes no prefix; its
twin, the model's blocked path (``blocked_sdpa(n_prefix=...)``,
``repro/models/layers.py:236-262``), does, and this is the port of it.

:func:`flash_attention_plain` is the port of ``_flash_fwd_impl``
(``repro/models/layers.py:151-185``), the function that the Pallas kernel
and ``repro.kernels.ref.flash_attention_ref`` compute: q pre-scaled in fp32
by ``1/sqrt(hd)``, an online softmax over KV blocks of ``kv_block`` keys
with running ``m``, ``l`` and ``acc`` in fp32, masked logits at ``-1e30``
and their probabilities zeroed, and ``acc / (l + 1e-30)`` cast to q's
dtype. The reference pads the sequence to a multiple of ``kv_block``
(``blocked_sdpa``, ``layers.py:249-254``); the padded keys lie past every
real query and are masked. The plain version pads the keys the same way
(and masks ``j >= T`` explicitly); query rows are independent, so it does
not pad them. The CUDA kernel, ``ckpt_flash_attention_fwd`` in
``csrc/flash_attention.cu``, masks the ragged tail instead and takes any
S and T at head widths 64, 128 and 256; its KV tiles are 128 keys in
bf16 (64 at hd 256, and 64 in fp32) whatever ``kv_block`` says.

With ``return_stats`` both also return each row's stats as
``_flash_fwd_impl`` carries them for the backward: ``m``, the running max
of the scaled logits (``-1e30`` for a row that sees no key), and ``l``,
the sum of their exponentials relative to ``m``, each fp32 ``(B, S, H)``.
The kernel writes them only where the caller passes buffers for them;
a call without them passes null pointers and stores nothing more.

Both are bound as one PyTorch operator, ``torch.ops.repro_torch.
flash_attention_fwd`` (:data:`OP`, a ``torch.library.custom_op``): its
CPU implementation is the plain version, its CUDA implementation the
kernel's launch, and its fake implementation gives the outputs' shapes
and dtypes, so a step traced on fake CUDA tensors (the dry run,
:mod:`repro_torch.launch.dryrun`) passes through it without a card. Its
FLOP formula for ``torch.utils.flop_counter`` is :func:`flash_flop`:
``4 * hd`` per visible (query, key) pair, the count the dry run and the
smoke's bound both take.
"""

from __future__ import annotations

import collections
import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from .build import CudaKernel
from .checksum import aligned

KINDS = ("full", "window", "chunked")
#: the head widths the CUDA kernel is built for (llama3.2-1b's and
#: musicgen-medium's 64; gemma3-27b's, llama2-7b's and the other attention
#: configs' 128; recurrentgemma-2b's and paligemma-3b's 256)
KERNEL_HEAD_DIM = frozenset({64, 128, 256})
#: CUDA grid limits on the head and batch axes
MAX_GRID_YZ = 65_535
NEG_INF = -1e30

KERNEL = CudaKernel("ckpt_flash_attention_fwd")
#: the kernel's launches by ``(hd, kind, prefix, stats)`` (``prefix``:
#: whether ``n_prefix`` was set), counted beside ``KERNEL.launches`` at
#: each launch
LAUNCHES_BY = collections.Counter()


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 kind: str, window: int, chunk: int,
                 n_prefix: int = 0) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"expected q (B, S, H, hd) and k, v (B, T, KV, hd), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[2]:
        raise ValueError(
            f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}: batch and "
            f"head width must agree and H a multiple of KV")
    if not (q.dtype == k.dtype == v.dtype) \
            or q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"expected one dtype, float32 or bfloat16; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    if kind == "chunked" and chunk < 1:
        raise ValueError(f"kind='chunked' needs chunk >= 1, got {chunk}")
    if n_prefix < 0:
        raise ValueError(f"n_prefix must be >= 0, got {n_prefix}")


def allowed(qpos: torch.Tensor, kpos: torch.Tensor, kind: str, window: int,
            chunk: int, n_prefix: int = 0) -> torch.Tensor:
    """(Sq, Sk) visibility between absolute positions."""
    i = qpos[:, None]
    j = kpos[None, :]
    m = j <= i
    if kind == "window":
        m = m & (j > i - window)
    elif kind == "chunked":
        m = m & ((i // chunk) == (j // chunk))
    if n_prefix:
        m = m | ((i < n_prefix) & (j < n_prefix))
    return m


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, kind: str = "full", window: int = 0,
                          chunk: int = 0, n_prefix: int = 0,
                          kv_block: int = 1024, return_stats: bool = False):
    """The attention in plain PyTorch ops, on any device; with
    ``return_stats``, ``(out, m, l)``."""
    check_inputs(q, k, v, kind, window, chunk, n_prefix)
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    rep = H // KV
    kvb = max(1, min(kv_block, T))
    pad = (-T) % kvb
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    f32 = torch.float32
    dev = q.device
    qg = q.reshape(B, S, KV, rep, hd).to(f32) * (1.0 / math.sqrt(hd))
    qpos = torch.arange(S, device=dev)
    m = torch.full((B, S, KV, rep), NEG_INF, dtype=f32, device=dev)
    l = torch.zeros((B, S, KV, rep), dtype=f32, device=dev)
    acc = torch.zeros((B, S, KV, rep, hd), dtype=f32, device=dev)
    for lo in range(0, T + pad, kvb):
        kpos = torch.arange(lo, lo + kvb, device=dev)
        k_j = k[:, lo:lo + kvb].to(f32)
        v_j = v[:, lo:lo + kvb].to(f32)
        logits = torch.einsum("bskrh,btkh->bskrt", qg, k_j)
        allow = allowed(qpos, kpos, kind, window, chunk, n_prefix) \
            & (kpos < T)
        allow = allow[None, :, None, None, :]
        logits = torch.where(allow, logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(-1))
        scale = torch.exp(m - m_new)
        pexp = torch.exp(logits - m_new[..., None])
        pexp = torch.where(allow, pexp, 0.0)
        l = l * scale + pexp.sum(-1)
        acc = acc * scale[..., None] + torch.einsum(
            "bskrt,btkh->bskrh", pexp, v_j)
        m = m_new
    out = acc / (l[..., None] + 1e-30)
    out = out.reshape(B, S, H * hd).to(q.dtype)
    if return_stats:
        return out, m.reshape(B, S, H), l.reshape(B, S, H)
    return out


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, kind: str = "full", window: int = 0,
                         chunk: int = 0, n_prefix: int = 0,
                         return_stats: bool = False):
    """Launch the kernel on CUDA tensors; returns ``(B, S, H * hd)``, or
    ``(out, m, l)`` with ``return_stats``."""
    check_inputs(q, k, v, kind, window, chunk, n_prefix)
    if q.device.type != "cuda" or k.device != q.device \
            or v.device != q.device:
        raise ValueError(f"expected CUDA tensors on one device, got "
                         f"{q.device}, {k.device}, {v.device}")
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    if hd not in KERNEL_HEAD_DIM or B > MAX_GRID_YZ or H > MAX_GRID_YZ:
        raise ValueError(
            f"the kernel takes hd {sorted(KERNEL_HEAD_DIM)} and B, H <= "
            f"{MAX_GRID_YZ}; got B {B}, H {H}, hd {hd}")
    q, k, v = (aligned(t.contiguous()) for t in (q, k, v))
    out = torch.empty((B, S, H * hd), dtype=q.dtype, device=q.device)
    args = (B, S, T, H, KV, hd, int(q.dtype == torch.bfloat16),
            KINDS.index(kind), window, chunk, n_prefix)
    m = l = None
    stats = (0, 0)  # null: the kernel stores no row stats
    if return_stats:
        m, l = (torch.empty((B, S, H), dtype=torch.float32, device=q.device)
                for _ in range(2))
        stats = (m.data_ptr(), l.data_ptr())
    KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  *stats, *args)
    LAUNCHES_BY[(hd, kind, bool(n_prefix), return_stats)] += 1
    return (out, m, l) if return_stats else out


# ------------------------------------------------------------ FLOP count
def flash_pairs(S: int, window: int = 0, n_prefix: int = 0, *,
                T: Optional[int] = None, kind: Optional[str] = None,
                chunk: int = 0) -> int:
    """Visible (query, key) pairs of S queries over ``T`` keys (``S`` when
    left out) under :func:`allowed`: causal, within ``window`` keys for
    ``kind="window"`` (the kind when ``window`` is set and ``kind`` is
    left out), inside the query's chunk for ``kind="chunked"``; each of
    the first ``n_prefix`` rows sees the whole prefix instead."""
    T = S if T is None else T
    kind = kind or ("window" if window else "full")
    i = np.arange(S, dtype=np.int64)
    hi = np.minimum(i + 1, T)
    if kind == "window":
        lo = np.maximum(i - window + 1, 0)
    elif kind == "chunked":
        lo = (i // chunk) * chunk
    else:
        lo = np.zeros_like(i)
    count = np.maximum(hi - lo, 0)
    n = min(n_prefix, S)
    count[:n] = min(n_prefix, T)  # a prefix row's causal keys lie inside it
    return int(count.sum())


def flash_flop(B: int, S: int, H: int, hd: int, window: int = 0,
               n_prefix: int = 0, *, T: Optional[int] = None,
               kind: Optional[str] = None, chunk: int = 0) -> int:
    """FLOP of the two products of the attention (``Q K^T`` and ``P V``):
    ``4 * hd`` per visible (query, key) pair (:func:`flash_pairs`) per
    (b, h)."""
    return 4 * hd * B * H * flash_pairs(S, window, n_prefix, T=T, kind=kind,
                                        chunk=chunk)


# ------------------------------------------------------- the operator
@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=(),
                         device_types="cpu")
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kind: str,
              window: int, chunk: int, n_prefix: int, kv_block: int,
              return_stats: bool
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(out, m, l)``; without ``return_stats`` m and l are empty. On the
    CPU: the plain version."""
    got = flash_attention_plain(q, k, v, kind=kind, window=window,
                                chunk=chunk, n_prefix=n_prefix,
                                kv_block=kv_block, return_stats=return_stats)
    return got if return_stats else (got, _no_stats(q), _no_stats(q))


def _no_stats(q: torch.Tensor) -> torch.Tensor:
    return q.new_empty((0,), dtype=torch.float32)


@_flash_op.register_kernel("cuda")
def _flash_op_cuda(q, k, v, kind, window, chunk, n_prefix, kv_block,
                   return_stats):
    # the module attribute is read at each call, so a caller that swaps
    # ``flash_attention_cuda`` (the smoke, to record each launch) sees
    # the model's launches
    got = flash_attention_cuda(q, k, v, kind=kind, window=window,
                               chunk=chunk, n_prefix=n_prefix,
                               return_stats=return_stats)
    return got if return_stats else (got, _no_stats(q), _no_stats(q))


@_flash_op.register_fake
def _flash_op_fake(q, k, v, kind, window, chunk, n_prefix, kv_block,
                   return_stats):
    check_inputs(q, k, v, kind, window, chunk, n_prefix)
    B, S, H, hd = q.shape
    out = q.new_empty((B, S, H * hd))
    if not return_stats:
        return out, _no_stats(q), _no_stats(q)
    return (out, q.new_empty((B, S, H), dtype=torch.float32),
            q.new_empty((B, S, H), dtype=torch.float32))


#: the operator as ``torch.ops`` holds it
OP = torch.ops.repro_torch.flash_attention_fwd


@register_flop_formula(OP)
def _flash_op_flop(q_shape, k_shape, v_shape, kind, window, chunk, n_prefix,
                   kv_block, return_stats, *, out_shape=None, **_kw) -> int:
    B, S, H, hd = q_shape
    return flash_flop(B, S, H, hd, window, n_prefix, T=k_shape[1],
                      kind=kind, chunk=chunk)
