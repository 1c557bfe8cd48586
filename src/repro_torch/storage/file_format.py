"""Streaming (write-side) file checksums for the ``.dsllm`` format.

``storage.manifest.file_checksum`` hashes a finished file by re-reading it
in fixed 4 MiB chunks and folding the per-chunk position-weighted digests as
``sum((i+1) * digest_i) mod 2^32``. That read-back pass used to run on the
commit lane — every persisted byte crossed the page cache twice.

The whole construction is *linear over bytes at absolute file positions*: a
byte ``v`` at position ``p`` contributes exactly

    (p // CHUNK + 1) * (v << 8*(p % 4)) * weight((p % CHUNK) // 4)   mod 2^32

where ``weight(j) = WEIGHT_BASE + (j % WEIGHT_MOD)`` is the checksum
kernel's per-word weight and unwritten gaps read (and hash) as zeros. So a
writer that never overwrites a byte — ``layout.FileWriter``'s append
discipline: offsets are assigned once and the cursor only moves forward —
can accumulate the exact same checksum *while writing*, one
:meth:`StreamingFileChecksum.contribution` per pwrite, and the commit lane
reuses the result instead of re-reading the file.

``contribution`` is pure compute (safe outside any lock); folding it into
the running total is a single modular add the writer performs under its
existing append lock. No new lock is introduced.
"""

from __future__ import annotations

import numpy as np

from repro_torch.kernels.checksum import WEIGHT_BASE, WEIGHT_MOD
from repro_torch.storage.manifest import CHECKSUM_CHUNK_BYTES

_U32_MASK = 0xFFFFFFFF


class StreamingFileChecksum:
    """Incremental, write-order-independent ``file_checksum`` accumulator.

    Valid only when every byte is written at most once (zero-filled gaps are
    fine — zeros are digest-neutral). ``layout.FileWriter`` guarantees this
    by construction; anything that rewrites in place must fall back to the
    read-back :func:`repro_torch.storage.manifest.file_checksum`.
    """

    def __init__(self, chunk_bytes: int = CHECKSUM_CHUNK_BYTES):
        assert chunk_bytes % 4 == 0
        self._chunk_words = chunk_bytes // 4
        self._total = 0

    @property
    def value(self) -> int:
        """The checksum of the file as written so far (== what
        ``file_checksum`` would return after re-reading it)."""
        return self._total

    def contribution(self, offset: int, data) -> int:
        """Checksum contribution of ``data`` written at absolute ``offset``.

        Pure compute — no accumulator state is touched, so callers can run
        it outside the writer lock and :meth:`fold` the result under it.
        """
        if isinstance(data, np.ndarray):
            b = np.ascontiguousarray(data).reshape(-1).view(np.uint8)
        else:
            b = np.frombuffer(memoryview(data), dtype=np.uint8)
        if b.size == 0:
            return 0
        # Align to u32 words: zero-pad the head (offset % 4) and the tail.
        head = offset % 4
        w0 = offset // 4
        pad_tail = (-(head + b.size)) % 4
        if head or pad_tail:
            b = np.concatenate([np.zeros(head, np.uint8), b,
                                np.zeros(pad_tail, np.uint8)])
        if not b.flags["C_CONTIGUOUS"] or b.ctypes.data % 4:
            b = b.copy()
        words = b.view(np.uint32).astype(np.uint64)
        w = w0 + np.arange(words.size, dtype=np.uint64)
        weight = WEIGHT_BASE + (w % self._chunk_words) % WEIGHT_MOD
        chunk_factor = w // self._chunk_words + 1
        # uint64 products/sums wrap mod 2^64, which is exact mod 2^32.
        total = int(np.sum(words * weight * chunk_factor, dtype=np.uint64))
        return total & _U32_MASK

    def fold(self, contribution: int) -> None:
        """Add one :meth:`contribution` — O(1); call under the writer lock."""
        self._total = (self._total + contribution) & _U32_MASK

    def update(self, offset: int, data) -> None:
        """``fold(contribution(offset, data))`` for single-threaded callers."""
        self.fold(self.contribution(offset, data))
