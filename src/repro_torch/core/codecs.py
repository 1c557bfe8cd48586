"""Tensor chunk codecs for encoded (non-raw) checkpoint payloads (port of
``repro/core/codecs.py``).

The engine's flush lanes treat any chunk with ``codec != "raw"`` the same
way: compress the producer-encoded payload and log-append it with explicit
raw-range addressing (``layout.FileWriter.append_encoded_chunk``). What
differs per codec is whether decoding is *self-contained* or *chained*:

* **chained** codecs (``xor+zstd``, differential checkpointing) encode a
  chunk relative to a previous checkpoint's bytes; their payloads only
  have meaning during chain replay (``RestoreEngine.restore_chain``).
* **self-contained** codecs (``int8q+zstd``, per-row int8 quantization of
  fp32 state) decode standalone, so a quantized tensor restores like any
  raw tensor, selective per-domain restores included.

Encode is one pass: each encoder returns ``(payload, digest)`` from one
kernel launch on the caller's device (the fused XOR+digest or
quantize+digest kernel on a card, their plain versions on the CPU); the
digest is the position-weighted u32 checksum of the uncompressed payload,
stored per chunk in the file footer and re-verified on decode.

``int8q`` payload layout (before the flush lane's compression), covering
raw fp32 bytes ``[raw_lo, raw_hi)`` of the tensor::

    u32 n_rows | u32 raw_nbytes | f32 scales[n_rows] | i8 q[n_rows * 256]

The raw bytes are viewed as fp32, zero-padded to whole rows of 256, and
each row gets a symmetric scale ``max|x| / 127``. Decode dequantizes and
truncates the pad.
"""

from __future__ import annotations

import struct
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.checksum import WEIGHT_BASE
from repro_torch.kernels.quantize import ROW_ELEMS, body_nbytes

#: fp32 elements per quantization row (the kernel's row width).
INT8_ROW_ELEMS = ROW_ELEMS
#: raw bytes per quantization row.
INT8_ROW_BYTES = INT8_ROW_ELEMS * 4

_INT8_HEADER = struct.Struct("<II")
_U32_MASK = 0xFFFFFFFF

DELTA_CODEC = "xor+zstd"
INT8_CODEC = "int8q+zstd"


class CodecError(ValueError):
    """A payload failed to decode (corrupt, truncated, or wrong codec)."""


def codec_base(codec: str) -> str:
    """``"int8q+zstd"`` -> ``"int8q"`` (strip the host-compression suffix)."""
    return codec.split("+", 1)[0]


def is_chained_codec(codec: str) -> bool:
    """True for codecs whose payloads only decode relative to a chain base
    (differential XOR deltas); such tensors cannot restore standalone."""
    return codec != "raw" and codec_base(codec) == "xor"


# ------------------------------------------------------------ chunk digests

def _header_digest(n_rows: int, raw_nbytes: int) -> int:
    """Digest contribution of the two ``int8q`` header words (idx 0 and 1)."""
    return (n_rows * WEIGHT_BASE + raw_nbytes * (WEIGHT_BASE + 1)) \
        & _U32_MASK


def payload_digest(payload, device: torch.device) -> int:
    """Position-weighted u32 digest of an uncompressed payload's bytes,
    computed on ``device``."""
    return ops.host_checksum(payload, device)


def int8_encoded_nbytes(raw_nbytes: int) -> int:
    """Exact ``int8q`` payload size for a chunk of ``raw_nbytes``, known
    before encoding, so the encode budget can reserve it up front."""
    n_rows = -(-raw_nbytes // INT8_ROW_BYTES)
    return _INT8_HEADER.size + body_nbytes(n_rows)


# --------------------------------------------------------------------- int8q

def encode_int8_block(raw, with_digest: bool, device: torch.device
                      ) -> Tuple[np.ndarray, Optional[int]]:
    """Quantize one chunk of raw fp32 bytes into an ``int8q`` payload on
    ``device``: ``(payload as a uint8 array, digest|None)`` from one pass.
    ``raw`` need not be a whole number of rows (a tensor's tail); the pad
    is zeros, which quantize exactly and which decode truncates."""
    raw = ops.host_u8(raw)
    raw_nbytes = raw.size
    pad = (-raw_nbytes) % INT8_ROW_BYTES
    if pad:
        raw = np.concatenate([raw, np.zeros(pad, np.uint8)])
    n_rows = raw.size // INT8_ROW_BYTES
    body, area = ops.host_fused_quantize_int8(raw, device)
    payload = np.empty(_INT8_HEADER.size + body.size, np.uint8)
    _INT8_HEADER.pack_into(payload, 0, n_rows, raw_nbytes)
    payload[_INT8_HEADER.size:] = body
    digest = (_header_digest(n_rows, raw_nbytes) + area) & _U32_MASK \
        if with_digest else None
    return payload, digest


def decode_int8_block(payload, raw_lo: int, raw_hi: int, expect_digest,
                      device: torch.device) -> np.ndarray:
    """Inverse of :func:`encode_int8_block` on ``device``: the dequantized
    raw bytes of ``[raw_lo, raw_hi)`` as a uint8 array. Each value is
    within half a quantization step (``row max|x| / 127``) of the
    original. With ``expect_digest`` the payload is verified in the same
    pass and a mismatch raises :class:`CodecError`."""
    data = ops.host_u8(payload)
    if data.size < _INT8_HEADER.size:
        raise CodecError("int8q payload shorter than its header")
    n_rows, raw_nbytes = _INT8_HEADER.unpack_from(data)
    if raw_nbytes != raw_hi - raw_lo:
        raise CodecError(
            f"int8q payload declares {raw_nbytes} raw bytes, chunk "
            f"addressing says [{raw_lo}:{raw_hi}) — corrupt payload")
    want = _INT8_HEADER.size + body_nbytes(n_rows)
    if data.size != want or n_rows < 1:
        raise CodecError(
            f"int8q payload is {data.size} B, expected {want} B for "
            f"{n_rows} rows — truncated or corrupt")
    out, area = ops.host_fused_dequantize_int8(
        data[_INT8_HEADER.size:], n_rows, device)
    if expect_digest is not None:
        got = (_header_digest(n_rows, raw_nbytes) + area) & _U32_MASK
        if got != expect_digest:
            raise CodecError(
                f"int8q payload digest mismatch: stored "
                f"{expect_digest:#010x}, decoded {got:#010x} — corrupt chunk")
    return out[:raw_nbytes]


# --------------------------------------------------------------------- delta

def encode_delta_chunk(cur: np.ndarray, prev: np.ndarray,
                       with_digest: bool, device: torch.device
                       ) -> Tuple[np.ndarray, Optional[int]]:
    """XOR-delta one chunk: ``(delta_bytes_u8, digest|None)`` in one pass
    over ``cur`` on ``device``."""
    if with_digest:
        return ops.host_xor_checksum(cur, prev, device)
    return ops.host_delta_xor(cur, prev, device), None


# ------------------------------------------------------------------ registry

#: self-contained decoders: codec base ->
#: fn(payload, raw_lo, raw_hi, expect_digest, device) -> u8.
_DECODERS: Dict[str, Callable[..., np.ndarray]] = {
    "int8q": decode_int8_block,
}


def decode_chunk_payload(codec: str, payload, raw_lo: int, raw_hi: int,
                         expect_digest, device: torch.device) -> np.ndarray:
    """Decode one decompressed self-contained payload back to raw bytes on
    ``device``. Chained codecs go through chain replay instead;
    ``expect_digest`` (the footer's per-chunk record) makes the decode
    verify the payload."""
    if is_chained_codec(codec):
        raise CodecError(
            f"codec {codec!r} is chained (differential) — its payloads "
            f"only decode during chain replay, not standalone")
    fn = _DECODERS.get(codec_base(codec))
    if fn is None:
        raise CodecError(f"unknown tensor chunk codec {codec!r}")
    return fn(payload, raw_lo, raw_hi, expect_digest, device)
