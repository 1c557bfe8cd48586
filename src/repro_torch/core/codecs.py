"""Tensor chunk codecs for encoded (non-raw) checkpoint payloads — the
delta half of ``repro/core/codecs.py``.

The engine's flush lanes treat any chunk with ``codec != "raw"`` the same
way: compress the producer-encoded payload and log-append it with explicit
raw-range addressing (``layout.FileWriter.append_encoded_chunk``).
**Chained** codecs (``xor+zstd``, differential checkpointing) encode a
chunk relative to a previous checkpoint's bytes; their payloads only have
meaning during chain replay (``RestoreEngine.restore_chain``).

Encode is one pass: :func:`encode_delta_chunk` returns ``(payload,
digest)`` from one launch of the fused XOR+digest kernel; the digest is
the position-weighted u32 checksum of the uncompressed payload, stored per
chunk in the file footer and re-verified on read.

The self-contained ``int8q`` codec is not yet ported: its payloads raise
:class:`CodecError` and are never misread.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

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


def payload_digest(payload, device: torch.device) -> int:
    """Position-weighted u32 digest of an uncompressed payload's bytes,
    computed on ``device``."""
    from repro_torch.kernels import ops

    return ops.host_checksum(payload, device)


def encode_delta_chunk(cur: np.ndarray, prev: np.ndarray,
                       with_digest: bool, device: torch.device
                       ) -> Tuple[np.ndarray, Optional[int]]:
    """XOR-delta one chunk: ``(delta_bytes_u8, digest|None)`` in one pass
    over ``cur`` on ``device``."""
    from repro_torch.kernels import ops

    if with_digest:
        return ops.host_xor_checksum(cur, prev, device)
    return ops.host_delta_xor(cur, prev, device), None


def decode_chunk_payload(codec: str, payload: bytes, raw_lo: int,
                         raw_hi: int, expect_digest=None) -> np.ndarray:
    """Decode one decompressed self-contained payload back to raw bytes.

    Chained codecs go through chain replay instead; ``int8q`` is not yet
    ported."""
    if is_chained_codec(codec):
        raise CodecError(
            f"codec {codec!r} is chained (differential) — its payloads "
            f"only decode during chain replay, not standalone")
    if codec_base(codec) == "int8q":
        raise CodecError("int8q not yet ported")
    raise CodecError(f"unknown tensor chunk codec {codec!r}")
