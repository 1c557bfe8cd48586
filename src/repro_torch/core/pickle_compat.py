"""Pickles that cross between the port and the JAX package.

The JAX package's sync engine pickles each tensor leaf as a numpy array,
and a bfloat16 leaf is an ``ml_dtypes.bfloat16`` array: its pickle
rebuilds the dtype as ``numpy.dtype(ml_dtypes.bfloat16, False, True)``
and sets that dtype's state before the array's. The port imports neither
``ml_dtypes`` nor ``repro``, and the card's host has no ``ml_dtypes``.

* :func:`load` / :func:`loads` read a pickle of either package with C's
  unpickler. Its ``find_class`` maps the global ``ml_dtypes.bfloat16`` to
  a stand-in, ``numpy.dtype`` of that stand-in to a placeholder whose
  ``BUILD`` does nothing (numpy's own dtype would drop the name numpy
  keeps in its metadata), and ``numpy.ndarray`` to :class:`_Array`, which
  takes the placeholder for :data:`~.dtypes.BF16_HOST` when the array's
  state is set. So a bfloat16 array arrives as its 2-byte words in
  ``BF16_HOST`` storage (``uint16`` that carries the name ``bfloat16``).
  Only arrays numpy pickles through ``_reconstruct`` (a dtype numpy does
  not know, an object or strided array) come back as :class:`_Array`, an
  ``ndarray`` subclass that pickles again as a plain ``ndarray``.
* :func:`dumps` writes a :data:`~.dtypes.BF16_HOST` array as the JAX
  package's pickle of an ``ml_dtypes.bfloat16`` array: the same
  ``_reconstruct`` call, the same dtype state, and the global named
  without importing its module. Every other object pickles as
  :func:`pickle.dumps` would pickle it. C's pickler cannot write that
  global: it imports the named module to check the object, and the card's
  host has no ``ml_dtypes``. So :func:`dumps` is the pure-Python pickler,
  with one change that keeps its bytes: an array's memory handed over as a
  ``PickleBuffer`` is written in place, where the base class copies it out
  first.
"""

from __future__ import annotations

import io
import pickle
import struct
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

    def _save_picklebuffer(self, obj: pickle.PickleBuffer) -> None:
        # the base class writes ``m.tobytes()``, a copy; the same opcodes
        # with the memory itself (C's pickler does so too)
        with obj.raw() as m:
            direct = self.proto >= 5 and m.contiguous and not m.readonly \
                and self._buffer_callback is None \
                and m.nbytes >= self.framer._FRAME_SIZE_TARGET
            if direct:
                self._write_large_bytes(
                    pickle.BYTEARRAY8 + struct.pack("<Q", m.nbytes), m)
        if not direct:
            pickle._Pickler.save_picklebuffer(self, obj)
            return
        self.memoize(obj)

    dispatch[pickle.PickleBuffer] = _save_picklebuffer

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


class _Bf16Dtype:
    """What ``numpy.dtype(ml_dtypes.bfloat16)`` unpickles to: its
    ``BUILD`` sets nothing, and :class:`_Array` reads it as
    :data:`~.dtypes.BF16_HOST`."""

    def __setstate__(self, state) -> None:
        pass


def _dtype(obj, align=False, copy=False):
    if obj is _Bf16Name:
        return _Bf16Dtype()
    return np.dtype(obj, align, copy)


class _Array(np.ndarray):
    """An array unpickled through numpy's ``_reconstruct``; a bfloat16
    one gets :data:`~.dtypes.BF16_HOST` storage."""

    def __setstate__(self, state) -> None:
        if isinstance(state[2], _Bf16Dtype):
            state = state[:2] + (dtypes.BF16_HOST,) + state[3:]
        super().__setstate__(state)

    def __reduce_ex__(self, protocol):
        return self.view(np.ndarray).__reduce_ex__(protocol)


class _Unpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if (module, name) == ("ml_dtypes", "bfloat16"):
            return _Bf16Name
        if (module, name) == ("numpy", "dtype"):
            return _dtype
        if (module, name) == ("numpy", "ndarray"):
            return _Array
        return super().find_class(module, name)


def load(f: BinaryIO) -> Any:
    """Unpickle from a binary file, bfloat16 arrays as
    :data:`~.dtypes.BF16_HOST` words."""
    return _Unpickler(f).load()


def loads(data: bytes) -> Any:
    return load(io.BytesIO(data))
