"""Dispatch of the port's kernels by the device of their input.

A tensor on the CPU goes to the kernel's plain PyTorch version; a tensor
on a CUDA device goes to the hand-written kernel, and a failed build or
launch raises — nothing falls back. The ``host_*`` helpers take
host-staged bytes (numpy arrays, ``bytes``, memoryviews) and a device:
they move the bytes there, run the kernel, and bring back only the
outputs, one chunk a call (the repro package feeds its kernels
host-staged chunks the same way, ``core/codecs.py:247`` and
``core/restore.py:837-840``). The checkpoint path feeds the segmented
kernels whole pieces itself, uploads from pinned memory and read-backs
enqueued without a wait: the digest (``storage/manifest.py``), the delta
encode and the int8 pair (``core/codecs.py``). Background lanes call them
inside :func:`lane_stream`.

Every kernel of ``repro/kernels/ops.py`` has its wrapper here:
``checksum`` (``tensor_checksum``, ``:63``; ``checksum_segments``
digests many chunks in one launch), ``xor_checksum``
(``fused_xor_checksum``, ``:108``; ``xor_checksum_segments`` encodes
many chunks in one launch), ``fused_xor_fold`` (``:119``),
``delta_xor`` (``:90``), ``delta_f32`` (``:99``), ``downcast_bf16``
(``:72``), ``quantize_int8`` (``:78``), ``dequantize_int8`` (``:84``),
``fused_quantize_int8`` (``:131``; ``fused_quantize_int8_segments``
encodes many chunks in one launch), ``fused_dequantize_int8``
(``:140``; ``fused_dequantize_int8_segments``) and ``flash_attention``
(``:151``). The reference pads the
u32 and f32 wrappers' inputs to 65,536-word blocks; these take any
length, and the offline reducer pads where the reference's bytes on disk
depend on it (``core/reduction.py``).
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from . import checksum as _checksum
from . import delta as _delta
from . import flash_attention as _fa
from . import fused as _fused
from . import quantize as _quant
from .checksum import U32_MASK, as_words

#: the restore fold moves at most this many bytes to the card per launch
XOR_PIECE_BYTES = 64 << 20


@contextlib.contextmanager
def lane_stream(device: torch.device) -> Iterator[Optional[object]]:
    """Run the enclosed kernels, copies and read-backs of a background lane
    on a CUDA stream of their own (from PyTorch's pool of non-blocking
    streams), so they neither queue behind nor synchronize with the work
    the training loop keeps on its stream. Yields the stream, or ``None``
    on the CPU, where there is nothing to switch."""
    device = torch.device(device)
    if device.type != "cuda":
        yield None
        return
    stream = torch.cuda.Stream(device=device)
    with torch.cuda.stream(stream):
        yield stream


def _kind(t: torch.Tensor) -> str:
    kind = t.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no checkpoint kernel for device {t.device}")
    return kind


def checksum(words: torch.Tensor) -> int:
    """Digest of int32 ``words`` (see :func:`as_words`)."""
    if _kind(words) == "cpu":
        return _checksum.checksum_plain(words)
    return int(_checksum.checksum_cuda(words).item()) & U32_MASK


def checksum_segments(words: torch.Tensor, seg_words: int,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The digest of each consecutive ``seg_words``-word segment of int32
    ``words``, as u32 bits in an int32 tensor on ``words``' device (into
    ``out`` if given). On a card this only enqueues: nothing waits for the
    kernel."""
    if _kind(words) == "cpu":
        return _checksum.checksum_segments_plain(words, seg_words, out)
    return _checksum.checksum_segments_cuda(words, seg_words, out)


def xor_checksum(a: torch.Tensor, b: torch.Tensor
                 ) -> Tuple[torch.Tensor, int]:
    """``(a ^ b, digest of a ^ b)`` over int32 word tensors."""
    if _kind(a) == "cpu":
        _delta.check_pair(a, b, "cpu")
        return _fused.xor_checksum_plain(a, b)
    delta, partials = _fused.xor_checksum_cuda(a, b)
    return delta, int(_fused.segment_digests(partials)[0])


def xor_checksum_segments(a: torch.Tensor, b: torch.Tensor, seg_words: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(a ^ b, partials)`` over the consecutive ``seg_words``-word
    segments of int32 word tensors, on their device: each row of
    ``partials`` sums to its segment's digest (``fused.segment_digests``).
    On a card this only enqueues: nothing waits for the kernel."""
    if _kind(a) == "cpu":
        return _fused.xor_checksum_segments_plain(a, b, seg_words)
    return _fused.xor_checksum_segments_cuda(a, b, seg_words)


def delta_xor(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a ^ b`` over int32 word tensors."""
    if _kind(a) == "cpu":
        _delta.check_pair(a, b, "cpu")
        return _delta.delta_xor_plain(a, b)
    return _delta.delta_xor_cuda(a, b)


def fused_xor_fold(base: torch.Tensor, delta: torch.Tensor
                   ) -> Tuple[torch.Tensor, int]:
    """``(base ^ delta, digest of delta)`` over int32 word tensors."""
    if _kind(base) == "cpu":
        _delta.check_pair(base, delta, "cpu")
        return _fused.xor_fold_checksum_plain(base, delta)
    folded, dig = _fused.xor_fold_checksum_cuda(base, delta)
    return folded, int(dig.item()) & U32_MASK


def delta_f32(cur: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """Flat ``cur - prev`` of two float32 tensors of one shape, with the
    reference's flushing (:mod:`.delta`)."""
    if _kind(cur) == "cpu":
        return _delta.delta_f32_plain(cur, prev)
    return _delta.delta_f32_cuda(cur, prev)


def downcast_bf16(x: torch.Tensor) -> torch.Tensor:
    """float32 ``(R, C)``, R and C multiples of 256 -> bfloat16."""
    if _kind(x) == "cpu":
        return _quant.downcast_bf16_plain(x)
    return _quant.downcast_bf16_cuda(x)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 ``(R, 256)``, R a multiple of 256 -> ``(q int8 (R, 256),
    scales float32 (R, 1))``."""
    if _kind(x) == "cpu":
        return _quant.quantize_int8_plain(x)
    return _quant.quantize_int8_cuda(x)


def dequantize_int8(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """``q * scales`` as float32 ``(R, 256)``."""
    if _kind(q) == "cpu":
        return _quant.dequantize_int8_plain(q, scales)
    return _quant.dequantize_int8_cuda(q, scales)


def fused_quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """``(int8q payload body, its digest)`` of float32 rows ``x`` of
    shape ``(n_rows, 256)``."""
    if _kind(x) == "cpu":
        return _quant.quantize_checksum_plain(x)
    body, dig = _quant.quantize_checksum_cuda(x)
    return body, int(dig.item()) & U32_MASK


def fused_dequantize_int8(body: torch.Tensor, n_rows: int
                          ) -> Tuple[torch.Tensor, int]:
    """``(float32 rows, digest)`` of an int8q payload body."""
    if _kind(body) == "cpu":
        return _quant.dequantize_checksum_plain(body, n_rows)
    out, dig = _quant.dequantize_checksum_cuda(body, n_rows)
    return out, int(dig.item()) & U32_MASK


def fused_quantize_int8_segments(x: torch.Tensor, valid_bytes: int,
                                 row_starts: Sequence[int],
                                 out: Optional[torch.Tensor] = None,
                                 dig: Optional[torch.Tensor] = None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(int8q payloads back to back, their digests as u32 bits in int32)``
    of the segments ``row_starts`` of raw fp32 bytes ``x``, the first
    ``valid_bytes`` of which are data (:mod:`.quantize`), on ``x``'s
    device (into ``out`` / ``dig`` if given). On a card this only
    enqueues: nothing waits for the kernel."""
    if _kind(x) == "cpu":
        return _quant.quantize_checksum_segments_plain(x, valid_bytes,
                                                       row_starts, out, dig)
    return _quant.quantize_checksum_segments_cuda(x, valid_bytes,
                                                  row_starts, out, dig)


def fused_dequantize_int8_segments(payloads: torch.Tensor,
                                   row_starts: Sequence[int],
                                   out: Optional[torch.Tensor] = None,
                                   dig: Optional[torch.Tensor] = None
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(float32 rows, digests)`` of back-to-back int8q payloads; on a
    card this only enqueues."""
    if _kind(payloads) == "cpu":
        return _quant.dequantize_checksum_segments_plain(payloads,
                                                         row_starts, out, dig)
    return _quant.dequantize_checksum_segments_cuda(payloads, row_starts,
                                                    out, dig)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    kind: str = "full", window: int = 0, chunk: int = 0,
                    n_prefix: int = 0, kv_block: int = 1024,
                    return_stats: bool = False):
    """Causal online-softmax attention: q ``(B, S, H, hd)``, k/v
    ``(B, T, KV, hd)`` -> ``(B, S, H * hd)`` in q's dtype (see
    :mod:`.flash_attention`), or ``(out, m, l)`` with ``return_stats``
    (fp32 ``(B, S, H)`` row stats); the first ``n_prefix`` positions
    also see each other (the prefix-LM). ``kv_block`` sets the plain
    version's KV blocks; the kernel tiles by 128 keys in bf16 (64 at hd
    256), 64 in fp32.

    It goes through the operator ``torch.ops.repro_torch.
    flash_attention_fwd`` (:data:`.flash_attention.OP`), so a step traced
    on fake tensors passes through it and ``FlopCounterMode`` counts it.

    Forward only: under grad with an input that requires it, this raises,
    since the operator has no backward and would cut the autograd graph
    without a word. To train through it, call
    ``repro_torch.models.layers._Flash`` (the port of the reference's
    ``_flash`` custom VJP, whose backward recomputes the probabilities
    from the row stats)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention is forward only: train through "
            "repro_torch.models.layers._Flash, whose backward is the "
            "blocked attention's (or run it under torch.no_grad())")
    _kind(q)  # a device with no kernel raises here, as for every wrapper
    out, m, l = _fa.OP(q, k, v, kind, window, chunk, n_prefix, kv_block,
                       return_stats)
    return (out, m, l) if return_stats else out


# ------------------------------------------------------ host-staged bytes
def host_u8(data) -> np.ndarray:
    """Flat uint8 numpy view of ``bytes``/memoryview/ndarray data."""
    if isinstance(data, np.ndarray):
        return data.reshape(-1).view(np.uint8)
    return np.frombuffer(memoryview(data), dtype=np.uint8)


def bytes_on(b: np.ndarray, device: torch.device) -> torch.Tensor:
    """A flat uint8 array as a tensor on ``device`` (copied where numpy's
    buffer cannot be shared: not contiguous, or read-only)."""
    if not b.flags["C_CONTIGUOUS"] or not b.flags["WRITEABLE"]:
        b = b.copy()
    t = torch.from_numpy(b)
    if device.type != "cpu":
        t = t.to(device)
    return t


def _words_on(b: np.ndarray, device: torch.device) -> torch.Tensor:
    return as_words(bytes_on(b, device))


def host_checksum(data, device: torch.device) -> int:
    """Digest of host bytes, computed on ``device``."""
    return checksum(_words_on(host_u8(data), torch.device(device)))


def _to_host(words: torch.Tensor, nbytes: int) -> np.ndarray:
    return words.cpu().numpy().view(np.uint8)[:nbytes]


def host_xor_checksum(cur, prev, device: torch.device
                      ) -> Tuple[np.ndarray, int]:
    """``(cur ^ prev as a fresh uint8 array, its digest)`` on ``device``."""
    cur, prev = host_u8(cur), host_u8(prev)
    device = torch.device(device)
    delta, dig = xor_checksum(_words_on(cur, device),
                              _words_on(prev, device))
    return _to_host(delta, cur.size), dig


def host_delta_xor(cur, prev, device: torch.device) -> np.ndarray:
    """``cur ^ prev`` as a fresh uint8 array, computed on ``device`` in
    pieces of at most :data:`XOR_PIECE_BYTES`."""
    cur, prev = host_u8(cur), host_u8(prev)
    device = torch.device(device)
    out = np.empty(cur.size, dtype=np.uint8)
    for lo in range(0, cur.size, XOR_PIECE_BYTES):
        hi = min(lo + XOR_PIECE_BYTES, cur.size)
        d = delta_xor(_words_on(cur[lo:hi], device),
                      _words_on(prev[lo:hi], device))
        out[lo:hi] = _to_host(d, hi - lo)
    return out
