"""Checkpoint data reduction: host compression, and the offline
differential checkpointer (port of ``repro/core/reduction.py``).

* ``_compress`` / ``_decompress`` (``:55-70``): zstd (level 3) when
  ``zstandard`` is importable, else zlib; reads sniff the frame, so
  payloads mix across installs. A zstd frame on a host without
  ``zstandard`` raises rather than being misread. The engine's flush lanes
  and codecs use this pair too.
* :func:`encode_tensor` / :func:`decode_tensor` (``:73-133``): one tensor
  through an optional quantize on its device (``bf16``: the
  ``downcast_bf16`` kernel; ``int8``: the ``quantize_int8`` kernel), an
  optional XOR delta against the previous working array (the
  ``delta_xor`` kernel), then host compression. The digest of the
  original bytes comes from the ``checksum_u32`` kernel.
* :class:`DifferentialCheckpointer` (``:136-237``): a keyframe + delta
  stream of a whole tree, one ``diff_{step:08d}.pkl`` record per save.

The reference calls the checkpointer deprecated for training, where the
engine's delta path (``DeltaPolicy``) replaces it; it stays for offline or
sidecar use and is the reference for the quantized encode. What the port
keeps, so that each package reads the other's records:

* Records are pickles of the same fields. The reference's records name
  ``repro.core.reduction.EncodedTensor``; :func:`load_record` maps that
  name to this module's class, so reading one imports nothing of
  ``repro``. The other way, ``repro`` unpickles this module's class, so it
  reads the port's records where ``repro_torch`` can be imported.
* Record names are ``jax.tree_util.keystr`` of each leaf's path
  (:func:`.tree.keystr`).
* A delta payload is the XOR of the two working arrays' u32 words, padded
  with zeros to a multiple of 65,536 words, as the reference's
  ``kops.delta_xor`` pads it (``repro/kernels/ops.py:_pad_to``).
* numpy has no bfloat16 here (no ``ml_dtypes``), so a bfloat16 working or
  decoded array is :data:`.dtypes.BF16_HOST`: uint16 storage that keeps
  the name, so a bf16 working array is never taken for a uint16 leaf's.
* A leaf keeps its dtype. The JAX package, with 64-bit types off, saves a
  64-bit leaf as 32-bit; the port saves it as it is.

Decode stays on the host, as in the reference (numpy XOR). The records
are written through :class:`..storage.backend.LocalBackend`'s atomic put
(a hidden temp file and a rename), which the reference does with a raw
``open``.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

try:
    import zstandard
except ImportError:  # the card's host has no zstandard
    zstandard = None

from ..convert import array_to_tensor
from ..kernels import ops
from ..kernels.checksum import as_words
from ..kernels.quantize import ROW_ELEMS, TILE
from ..storage.backend import LocalBackend
from . import dtypes
from .tree import flatten_with_path, keystr

_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"
#: the reference's ``delta_xor`` pads both u32 views to this many words
DELTA_BLOCK_WORDS = 65_536


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


@dataclasses.dataclass
class EncodedTensor:
    codec: str                  # "raw" | "delta-xor"
    quant: str                  # "none" | "bf16" | "int8"
    payload: bytes              # compressed
    dtype: str                  # numpy-style name of the original leaf
    shape: Tuple[int, ...]
    checksum: int               # of the *original* bytes
    raw_nbytes: int
    scales: Optional[bytes] = None


class _RecordUnpickler(pickle.Unpickler):
    """Reads a record of either package: the reference's
    ``EncodedTensor`` is taken as this module's, without importing
    ``repro``."""

    def find_class(self, module: str, name: str):
        if (module, name) == ("repro.core.reduction", "EncodedTensor"):
            return EncodedTensor
        return super().find_class(module, name)


def load_record(path: str) -> Dict[str, Any]:
    """One ``diff_*.pkl`` record, written by either package."""
    with open(path, "rb") as fh:
        return _RecordUnpickler(fh).load()


def _padded_words(t: torch.Tensor) -> torch.Tensor:
    w = as_words(t)
    pad = (-w.numel()) % DELTA_BLOCK_WORDS
    return torch.cat([w, w.new_zeros(pad)]) if pad else w


def encode_tensor(t: torch.Tensor, *, prev: Optional[np.ndarray] = None,
                  quant: str = "none") -> Tuple[EncodedTensor, np.ndarray]:
    """Encode one tensor, on its device: optional quantize, optional XOR
    delta against ``prev`` (same working domain), then host compression.
    Returns the record *and* the working-precision host array (the
    ``prev`` to retain for the next delta)."""
    t = t.detach().contiguous()
    checksum = ops.checksum(as_words(t))
    dtype, shape = dtypes.of_tensor(t).name, tuple(t.shape)
    scales = None
    rows = t.dtype == torch.float32 and t.dim() == 2 \
        and t.shape[0] % TILE == 0
    if quant == "bf16" and rows and t.shape[1] % TILE == 0:
        work_t = ops.downcast_bf16(t)
    elif quant == "int8" and rows and t.shape[1] == ROW_ELEMS:
        work_t, s = ops.quantize_int8(t)
        scales = _compress(dtypes.host_copy(s).tobytes())
    else:
        quant = "none"
        work_t = t
    work = dtypes.host_copy(work_t)
    if prev is not None and prev.shape == work.shape \
            and dtypes.host_name(prev) == dtypes.host_name(work):
        delta = ops.delta_xor(
            _padded_words(work_t),
            _padded_words(ops.bytes_on(ops.host_u8(prev), t.device)))
        payload = _compress(dtypes.host_copy(delta).tobytes())
        codec = "delta-xor"
    else:
        payload = _compress(np.ascontiguousarray(work).tobytes())
        codec = "raw"
    return EncodedTensor(codec=codec, quant=quant, payload=payload,
                         dtype=dtype, shape=shape, checksum=checksum,
                         raw_nbytes=t.numel() * t.element_size(),
                         scales=scales), work


def _host_dtype(name: str) -> np.dtype:
    return dtypes.BF16_HOST if name == "bfloat16" else np.dtype(name)


def decode_tensor(enc: EncodedTensor, *, prev: Optional[np.ndarray] = None
                  ) -> np.ndarray:
    """Inverse of encode (returns the *working-precision* array: int8 q
    for ``int8``, :data:`BF16_HOST` for ``bf16``), on the host."""
    raw = _decompress(enc.payload)
    if enc.codec == "delta-xor":
        if prev is None:
            raise ValueError("delta decode needs the previous snapshot")
        n_u32 = len(raw) // 4
        delta = np.frombuffer(raw, np.uint32)
        prev_u32 = prev.reshape(-1).view(np.uint8)
        pad = (-len(prev_u32)) % 4
        prev_u32 = np.pad(prev_u32, (0, pad)).view(np.uint32)
        pad2 = n_u32 - len(prev_u32)
        if pad2:
            prev_u32 = np.pad(prev_u32, (0, pad2))
        work = np.bitwise_xor(delta, prev_u32).view(np.uint8)
    else:
        work = np.frombuffer(raw, np.uint8)
    n = int(np.prod(enc.shape))
    if enc.quant == "bf16":
        arr = work[:n * 2].view(dtypes.BF16_HOST)
    elif enc.quant == "int8":
        arr = work[:n].view(np.int8)
    else:
        arr = work[:enc.raw_nbytes].view(_host_dtype(enc.dtype))
    return np.array(arr).reshape(enc.shape)


def _leaf_tensor(leaf: Any, device: torch.device) -> torch.Tensor:
    """A leaf on ``device``: a tensor as it is, anything else through
    numpy (a bfloat16 array by its name, :func:`.dtypes.of_array`)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to(device)
    return array_to_tensor(np.asarray(leaf), device)


class DifferentialCheckpointer:
    """Keyframe + delta checkpoint stream for a tree of tensors.

    Offline or sidecar use: it bypasses the async engine, the catalog and
    restore engine (``CheckpointManager(..., delta=DeltaPolicy())`` is the
    training path). Every leaf is moved to ``device`` and encoded there by
    the kernels; ``device="cuda"`` without a card raises.
    """

    def __init__(self, directory: str, *, keyframe_every: int = 4,
                 quant: str = "none", device="cuda"):
        self.directory = directory
        self.keyframe_every = keyframe_every
        self.quant = quant
        # imported here: the engine imports this module for _compress
        from .checkpoint import resolve_device
        self.device = resolve_device(device)
        self._backend = LocalBackend(directory)
        self._prev: Dict[str, np.ndarray] = {}
        self._n_saves = 0
        # Restart recovery: the cadence comes from what is on disk, and
        # the delta bases are re-armed from the last restorable step, so
        # the chain continues across the restart; a damaged tail leaves no
        # bases, and the next save is a keyframe.
        existing = self._existing_steps()
        if existing:
            self._n_saves = len(existing)
            try:
                self._prev = self.restore(existing[-1])
            except Exception:
                self._prev = {}

    def _existing_steps(self) -> List[int]:
        return sorted(int(f[5:13]) for f in os.listdir(self.directory)
                      if f.startswith("diff_") and f.endswith(".pkl"))

    def save(self, step: int, tree) -> Dict[str, Any]:
        leaves = flatten_with_path(tree)[0]
        # no retained bases: this save is raw-encoded whatever the
        # cadence says, so it is recorded as the keyframe it is
        keyframe = (self._n_saves % self.keyframe_every == 0) \
            or not self._prev
        record: Dict[str, Any] = {"step": step, "keyframe": keyframe,
                                  "tensors": {}}
        raw_total = comp_total = 0
        for path, leaf in leaves:
            name = keystr(path)
            prev = None if keyframe else self._prev.get(name)
            enc, work = encode_tensor(_leaf_tensor(leaf, self.device),
                                      prev=prev, quant=self.quant)
            self._prev[name] = work
            record["tensors"][name] = enc
            raw_total += enc.raw_nbytes
            comp_total += len(enc.payload)
        key = f"diff_{step:08d}.pkl"
        self._backend.put(key, pickle.dumps(
            record, protocol=pickle.HIGHEST_PROTOCOL))
        self._n_saves += 1
        return {"path": os.path.join(self.directory, key),
                "raw_bytes": raw_total, "compressed_bytes": comp_total,
                "ratio": raw_total / max(comp_total, 1),
                "keyframe": keyframe}

    def restore(self, step: int) -> Dict[str, np.ndarray]:
        """Replay keyframe + deltas up to ``step``: working arrays on the
        host, keyed by record name."""
        chain: List[Dict[str, Any]] = []
        for f in sorted(os.listdir(self.directory)):
            if not f.startswith("diff_"):
                continue
            if int(f[5:13]) > step:
                break
            try:
                rec = load_record(os.path.join(self.directory, f))
            except Exception:
                # a broken link invalidates everything accumulated so far:
                # only a later keyframe re-anchors the chain, never a
                # splice across a damaged record
                chain = []
                continue
            if rec["keyframe"]:
                chain = [rec]
            else:
                chain.append(rec)
        if not (chain and chain[0]["keyframe"]):
            raise ValueError(f"no keyframe found for step {step} in "
                             f"{self.directory}")
        state: Dict[str, np.ndarray] = {}
        for rec in chain:
            for name, enc in rec["tensors"].items():
                state[name] = decode_tensor(enc, prev=state.get(name))
        return state
