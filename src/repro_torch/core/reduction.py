"""Host compression of encoded chunk payloads (the ``_compress`` /
``_decompress`` pair of ``repro/core/reduction.py``; the offline
differential checkpointer there is not yet ported).

zstd (level 3) when ``zstandard`` is importable, else zlib; reads sniff
the frame, so payloads mix across installs. A zstd frame on a host
without ``zstandard`` raises rather than being misread.
"""

from __future__ import annotations

import zlib

try:
    import zstandard
except ImportError:  # the card's host has no zstandard
    zstandard = None

_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"


def _compress(b: bytes, level: int = 3) -> bytes:
    if zstandard is not None:
        return zstandard.ZstdCompressor(level=level).compress(b)
    return zlib.compress(b, level)


def _decompress(b: bytes) -> bytes:
    if b[:4] == _ZSTD_MAGIC:
        if zstandard is None:
            raise RuntimeError(
                "payload was compressed with zstandard, which is not "
                "installed on this host")
        return zstandard.ZstdDecompressor().decompress(b)
    return zlib.decompress(b)
