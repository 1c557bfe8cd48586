"""The port's dtype table: on-disk name -> torch dtype and numpy storage.

Files name dtypes as numpy does (``"float32"``, ``"bfloat16"``, ...), so
the JAX package reads the port's files and the other way round. numpy has
no ``bfloat16`` without ``ml_dtypes``, which the card's host lacks, so a
bfloat16 tensor is held on the host as ``uint16`` storage of the same
width and turned back with ``.view(torch.bfloat16)``. Where a host array
must still say that it holds bfloat16 (the offline reducer's working
arrays), its dtype is :data:`BF16_HOST`: ``uint16`` that carries the name
in its metadata (:func:`host_name`).
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch


class DType(NamedTuple):
    name: str              # numpy-style name written to disk
    torch: torch.dtype
    storage: np.dtype      # host numpy dtype of the same width

    @property
    def itemsize(self) -> int:
        return self.storage.itemsize


_TABLE = [
    DType("float32", torch.float32, np.dtype(np.float32)),
    DType("float64", torch.float64, np.dtype(np.float64)),
    DType("float16", torch.float16, np.dtype(np.float16)),
    DType("bfloat16", torch.bfloat16, np.dtype(np.uint16)),
    DType("int64", torch.int64, np.dtype(np.int64)),
    DType("int32", torch.int32, np.dtype(np.int32)),
    DType("int16", torch.int16, np.dtype(np.int16)),
    DType("int8", torch.int8, np.dtype(np.int8)),
    DType("uint8", torch.uint8, np.dtype(np.uint8)),
    DType("bool", torch.bool, np.dtype(np.bool_)),
]
BY_NAME: Dict[str, DType] = {d.name: d for d in _TABLE}
#: uint16 host storage that remembers it holds bfloat16 (numpy compares
#: dtypes without their metadata, so compare :func:`host_name` instead)
BF16_HOST = np.dtype(np.uint16, metadata={"name": "bfloat16"})
BY_TORCH: Dict[torch.dtype, DType] = {d.torch: d for d in _TABLE}


def lookup(name: str) -> DType:
    try:
        return BY_NAME[name]
    except KeyError:
        raise ValueError(f"dtype {name!r} is not in the port's dtype "
                         f"table") from None


def of_tensor(t: torch.Tensor) -> DType:
    try:
        return BY_TORCH[t.dtype]
    except KeyError:
        raise ValueError(f"tensor dtype {t.dtype} is not in the port's "
                         f"dtype table") from None


def host_name(a: np.ndarray) -> str:
    """The dtype name of a host array: ``"bfloat16"`` for an ``ml_dtypes``
    bfloat16 array and for :data:`BF16_HOST` storage, numpy's name
    otherwise."""
    md = a.dtype.metadata
    return md["name"] if md and "name" in md else a.dtype.name


def of_array(a: np.ndarray) -> DType:
    """Entry for a numpy array; an ``ml_dtypes`` bfloat16 array (named
    ``"bfloat16"`` by numpy) and :data:`BF16_HOST` storage map to the
    bfloat16 entry."""
    return lookup(host_name(a))


def host_view(buf: np.ndarray, name: str) -> np.ndarray:
    """``buf``'s bytes as the storage dtype of ``name``."""
    return buf.reshape(-1).view(np.uint8).view(lookup(name).storage)


def host_to_tensor(buf: np.ndarray, name: str,
                   device: torch.device) -> torch.Tensor:
    """A host buffer holding dtype ``name`` as a tensor on ``device``
    (shape kept, bytes unchanged)."""
    shape = tuple(buf.shape)
    flat = np.ascontiguousarray(buf).reshape(-1).view(np.uint8)
    t = torch.from_numpy(flat).view(lookup(name).torch).reshape(shape)
    return t.to(device) if torch.device(device).type != "cpu" else t


def host_copy(t: torch.Tensor) -> np.ndarray:
    """A copy of a tensor's values as a host array (never a view: tensors
    are updated in place); bfloat16 as :data:`BF16_HOST`. From a card it
    is one blocking copy into pageable memory."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).to("cpu", copy=True).numpy() \
            .view(BF16_HOST)
    return t.to("cpu", copy=True).numpy()


def cast_host(a: np.ndarray, src: str, dst: str) -> np.ndarray:
    """The values of ``a`` (storage of dtype ``src``) cast to dtype ``dst``,
    as storage of ``dst``, bit for bit as numpy with ``ml_dtypes`` casts
    them (the JAX package's dtype-converting restore). Between numpy
    dtypes that is numpy's cast. bfloat16 goes through float32 both ways:
    widened exactly, narrowed to nearest even, a NaN made the quiet NaN of
    its sign (``0x7fc0``), and a bfloat16 NaN becomes float16's quiet NaN
    of its sign (``0x7e00``)."""
    if src == dst:
        return a
    if src == "bfloat16":
        words = np.asarray(a).view(np.uint16)
        f = (words.astype(np.uint32) << 16).view(np.float32)
        if dst != "float16":
            return f.astype(lookup(dst).storage)
        return np.where(np.isnan(f),
                        ((words & 0x8000) | 0x7e00).view(np.float16),
                        f.astype(np.float16))
    if dst == "bfloat16":
        u = np.asarray(a).astype(np.float32).view(np.uint32)
        rne = (u + np.uint32(0x7FFF) + ((u >> 16) & 1)) >> 16
        nan = (u & 0x7FFFFFFF) > 0x7F800000
        out = np.where(nan, ((u >> 16) & 0x8000) | 0x7FC0, rne)
        return out.astype(np.uint16)
    return np.asarray(a).astype(lookup(dst).storage)
