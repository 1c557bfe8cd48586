"""Pickles that cross between the port and the JAX package.

The JAX package's sync engine pickles each tensor leaf as a numpy array,
and a bfloat16 leaf is an ``ml_dtypes.bfloat16`` array: its pickle
rebuilds the dtype as ``numpy.dtype(ml_dtypes.bfloat16, False, True)``
and sets that dtype's state before the array's. The port imports neither
``ml_dtypes`` nor ``repro``, and the card's host has no ``ml_dtypes``.

* :func:`load` / :func:`loads` read a pickle of either package. The global
  ``ml_dtypes.bfloat16`` is mapped to a stand-in, so a bfloat16 array
  arrives as its 2-byte words in :data:`~.dtypes.BF16_HOST` storage
  (``uint16`` that carries the name ``bfloat16``).
* :func:`dumps` writes a :data:`~.dtypes.BF16_HOST` array as the JAX
  package's pickle of an ``ml_dtypes.bfloat16`` array: the same
  ``_reconstruct`` call, the same dtype state, and the global named
  without importing its module. Every other object pickles as
  :func:`pickle.dumps` would pickle it.

Both are the pure-Python pickler and unpickler of :mod:`pickle`: only
they let a subclass write a named global and skip one ``BUILD``. A sync
pickle holds few objects and large byte strings, which they copy in one
piece, so they cost little beside the bytes.
"""

from __future__ import annotations

import io
import pickle
from typing import Any, BinaryIO

import numpy as np

from . import dtypes

#: what numpy sets on an ``ml_dtypes.bfloat16`` dtype when it unpickles
#: one: (version, byte order, subarray, names, fields, item size,
#: alignment, flags)
_BF16_DTYPE_STATE = (3, "<", None, None, None, 2, 2, 64)


class _Global:
    """A module-level name written into a pickle without importing its
    module (the pickler's own globals must import)."""

    def __init__(self, module: str, name: str):
        self.module = module
        self.name = name

    def __call__(self, *args):  # a reduce function must be callable
        raise TypeError(f"{self.module}.{self.name} is only pickled here")


_ML_BF16 = _Global("ml_dtypes", "bfloat16")


class _Bf16Dtype:
    """Pickles as ``numpy.dtype(ml_dtypes.bfloat16)`` does."""

    def __reduce__(self):
        return (np.dtype, (_ML_BF16, False, True), _BF16_DTYPE_STATE)


_BF16_DTYPE = _Bf16Dtype()
#: numpy's ``_reconstruct`` (``numpy._core.multiarray`` in numpy 2,
#: ``numpy.core.multiarray`` before), as numpy's own reduction names it
_RECONSTRUCT = np.empty(0, np.uint8).__reduce__()[0]


def _is_bf16_host(obj: Any) -> bool:
    return isinstance(obj, np.ndarray) and obj.dtype == np.uint16 \
        and dtypes.host_name(obj) == "bfloat16"


class _Pickler(pickle._Pickler):
    dispatch = dict(pickle._Pickler.dispatch)

    def _save_named_global(self, obj: _Global) -> None:
        # what save_global writes for a protocol >= 4 global
        self.save(obj.module)
        self.save(obj.name)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)

    dispatch[_Global] = _save_named_global

    def reducer_override(self, obj):
        if not _is_bf16_host(obj):
            return NotImplemented
        a = obj if obj.flags.c_contiguous else obj.copy(order="C")
        # numpy's own reduction of a C-ordered array of a custom dtype
        return (_RECONSTRUCT, (np.ndarray, (0,), b"b"),
                (1, a.shape, _BF16_DTYPE, False, a.tobytes()))


def dumps(obj: Any) -> bytes:
    """``pickle.dumps(obj, protocol=HIGHEST_PROTOCOL)``, with
    :data:`~.dtypes.BF16_HOST` arrays written as ``ml_dtypes.bfloat16``
    arrays."""
    buf = io.BytesIO()
    _Pickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
    return buf.getvalue()


class _Bf16Name:
    """Stands in for the class ``ml_dtypes.bfloat16``."""


def _dtype(obj, align=False, copy=False):
    if obj is _Bf16Name:
        return dtypes.BF16_HOST
    return np.dtype(obj, align, copy)


class _Unpickler(pickle._Unpickler):
    dispatch = dict(pickle._Unpickler.dispatch)

    def find_class(self, module: str, name: str):
        if (module, name) == ("ml_dtypes", "bfloat16"):
            return _Bf16Name
        if (module, name) == ("numpy", "dtype"):
            return _dtype
        return super().find_class(module, name)

    def _load_build(self) -> None:
        # numpy would set the bfloat16 dtype's state on the stand-in,
        # clearing its name: the stand-in needs none
        if self.stack[-2] is dtypes.BF16_HOST:
            self.stack.pop()
            return
        pickle._Unpickler.load_build(self)

    dispatch[pickle.BUILD[0]] = _load_build


def load(f: BinaryIO) -> Any:
    """Unpickle from a binary file, bfloat16 arrays as
    :data:`~.dtypes.BF16_HOST` words."""
    return _Unpickler(f).load()


def loads(data: bytes) -> Any:
    return load(io.BytesIO(data))
