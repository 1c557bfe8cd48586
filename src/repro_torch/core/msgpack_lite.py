"""Pure-Python msgpack for the ``.dsllm`` footer and object entries.

The card's host has no ``msgpack`` package. The footer (``core/layout``)
and msgpack object entries use a small subset of the format — dict,
list/tuple, str, bytes, int, float, bool and None — and for that subset
:func:`packb` emits exactly the bytes of ``msgpack.packb(obj,
use_bin_type=True)`` (smallest integer encoding, float64, str8/bin types),
so both packages write identical footers. :func:`unpackb` reads what
``msgpack.unpackb(data, raw=False)`` reads for that subset (arrays come
back as lists).
"""

from __future__ import annotations

import struct
from typing import Any, List, Tuple


class PackError(TypeError):
    """A value outside the supported subset."""


def _pack_int(v: int, out: List[bytes]) -> None:
    if 0 <= v < 0x80:
        out.append(struct.pack("B", v))
    elif -0x20 <= v < 0:
        out.append(struct.pack("b", v))
    elif v >= 0:
        for code, fmt, lim in ((0xcc, ">B", 1 << 8), (0xcd, ">H", 1 << 16),
                               (0xce, ">I", 1 << 32), (0xcf, ">Q", 1 << 64)):
            if v < lim:
                out.append(struct.pack("B", code) + struct.pack(fmt, v))
                return
        raise PackError(f"integer {v} does not fit in 64 bits")
    else:
        for code, fmt, lim in ((0xd0, ">b", 1 << 7), (0xd1, ">h", 1 << 15),
                               (0xd2, ">i", 1 << 31), (0xd3, ">q", 1 << 63)):
            if v >= -lim:
                out.append(struct.pack("B", code) + struct.pack(fmt, v))
                return
        raise PackError(f"integer {v} does not fit in 64 bits")


def _pack_len(n: int, fix_code: int, fix_max: int,
              codes: Tuple[Tuple[int, str, int], ...], out: List[bytes]
              ) -> None:
    if fix_code >= 0 and n < fix_max:
        out.append(struct.pack("B", fix_code | n))
        return
    for code, fmt, lim in codes:
        if n < lim:
            out.append(struct.pack("B", code) + struct.pack(fmt, n))
            return
    raise PackError(f"length {n} too large for msgpack")


_STR = ((0xd9, ">B", 1 << 8), (0xda, ">H", 1 << 16), (0xdb, ">I", 1 << 32))
_BIN = ((0xc4, ">B", 1 << 8), (0xc5, ">H", 1 << 16), (0xc6, ">I", 1 << 32))
_ARR = ((0xdc, ">H", 1 << 16), (0xdd, ">I", 1 << 32))
_MAP = ((0xde, ">H", 1 << 16), (0xdf, ">I", 1 << 32))


def _pack(obj: Any, out: List[bytes]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif type(obj) is int:
        _pack_int(obj, out)
    elif type(obj) is float:
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif type(obj) is str:
        b = obj.encode("utf-8")
        _pack_len(len(b), 0xa0, 32, _STR, out)
        out.append(b)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        _pack_len(len(b), -1, 0, _BIN, out)
        out.append(b)
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 16, _ARR, out)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 16, _MAP, out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise PackError(
            f"can not serialize {type(obj).__name__!r} object")


def packb(obj: Any) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)`` for the supported subset."""
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("msgpack data truncated")
        b = self.buf[self.pos:end]
        self.pos = end
        return b

    def unpack(self, fmt: str) -> Any:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _read(r: _Reader) -> Any:
    c = r.take(1)[0]
    if c < 0x80:
        return c
    if c >= 0xe0:
        return c - 0x100
    if 0x80 <= c <= 0x8f:
        return _read_map(r, c & 0x0f)
    if 0x90 <= c <= 0x9f:
        return _read_arr(r, c & 0x0f)
    if 0xa0 <= c <= 0xbf:
        return r.take(c & 0x1f).decode("utf-8")
    simple = {0xc0: None, 0xc2: False, 0xc3: True}
    if c in simple:
        return simple[c]
    ints = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
            0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q",
            0xca: ">f", 0xcb: ">d"}
    if c in ints:
        return r.unpack(ints[c])
    lens = {0xd9: (">B", "str"), 0xda: (">H", "str"), 0xdb: (">I", "str"),
            0xc4: (">B", "bin"), 0xc5: (">H", "bin"), 0xc6: (">I", "bin"),
            0xdc: (">H", "arr"), 0xdd: (">I", "arr"),
            0xde: (">H", "map"), 0xdf: (">I", "map")}
    if c not in lens:
        raise ValueError(f"unsupported msgpack type byte {c:#04x}")
    fmt, kind = lens[c]
    n = r.unpack(fmt)
    if kind == "str":
        return r.take(n).decode("utf-8")
    if kind == "bin":
        return bytes(r.take(n))
    if kind == "arr":
        return _read_arr(r, n)
    return _read_map(r, n)


def _read_arr(r: _Reader, n: int) -> list:
    return [_read(r) for _ in range(n)]


def _read_map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        k = _read(r)
        out[k] = _read(r)
    return out


def unpackb(data: bytes) -> Any:
    """``msgpack.unpackb(data, raw=False)`` for the supported subset."""
    r = _Reader(bytes(data))
    obj = _read(r)
    if r.pos != len(r.buf):
        raise ValueError("extra bytes after msgpack object")
    return obj
