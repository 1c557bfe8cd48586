"""A frozen reader of the checkpoint format the program writes (one
``.dsllm`` file a rank under ``global_step<N>/``, a catalog manifest
``.catalog/step-<N:012d>.json`` written last), kept here so that what a
save wrote is judged by code the program cannot change.

A file ends in a trailer (``<Q8s``: the footer's length and the magic
``DSLLMCK1``) after a msgpack footer: ``tensors`` (name, offset, nbytes,
dtype, shape, codec, ``enc_chunks``), ``objects`` (name, offset, nbytes,
codec) and ``meta`` (``delta``: keyframe or base step). A ``raw`` tensor
sits at its offset; an encoded one is a list of compressed chunks
``(file offset, compressed bytes, raw lo, raw hi, digest)``, each zlib or
zstd. ``xor`` chunks are the XOR of the tensor's bytes with the base
step's; ``int8q`` chunks hold ``u32 n_rows, u32 raw_nbytes, f32
scales[n_rows], i8 q[n_rows * 256]``, the chunk's float32 values being
``q * scale`` of their row, the pad past ``raw_nbytes`` cut.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

MAGIC = b"DSLLMCK1"
TRAILER = struct.Struct("<Q8s")
ROW_ELEMS = 256
ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"


# ------------------------------------------------------------------ msgpack
def _unpack(buf: bytes, pos: int) -> Tuple[Any, int]:
    c = buf[pos]
    pos += 1
    if c < 0x80:
        return c, pos
    if c >= 0xe0:
        return c - 0x100, pos
    if c <= 0x8f:
        return _unpack_map(buf, pos, c & 0x0f)
    if c <= 0x9f:
        return _unpack_arr(buf, pos, c & 0x0f)
    if c <= 0xbf:
        n = c & 0x1f
        return buf[pos:pos + n].decode("utf-8"), pos + n
    if c in (0xc0, 0xc2, 0xc3):
        return {0xc0: None, 0xc2: False, 0xc3: True}[c], pos
    fixed = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q", 0xd0: ">b",
             0xd1: ">h", 0xd2: ">i", 0xd3: ">q", 0xca: ">f", 0xcb: ">d"}
    if c in fixed:
        fmt = fixed[c]
        return struct.unpack_from(fmt, buf, pos)[0], \
            pos + struct.calcsize(fmt)
    sized = {0xd9: (">B", "str"), 0xda: (">H", "str"), 0xdb: (">I", "str"),
             0xc4: (">B", "bin"), 0xc5: (">H", "bin"), 0xc6: (">I", "bin"),
             0xdc: (">H", "arr"), 0xdd: (">I", "arr"),
             0xde: (">H", "map"), 0xdf: (">I", "map")}
    if c not in sized:
        raise ValueError(f"msgpack type byte {c:#04x}")
    fmt, kind = sized[c]
    n = struct.unpack_from(fmt, buf, pos)[0]
    pos += struct.calcsize(fmt)
    if kind == "arr":
        return _unpack_arr(buf, pos, n)
    if kind == "map":
        return _unpack_map(buf, pos, n)
    raw = buf[pos:pos + n]
    return (raw.decode("utf-8") if kind == "str" else bytes(raw)), pos + n


def _unpack_arr(buf, pos, n):
    out = []
    for _ in range(n):
        v, pos = _unpack(buf, pos)
        out.append(v)
    return out, pos


def _unpack_map(buf, pos, n):
    out = {}
    for _ in range(n):
        k, pos = _unpack(buf, pos)
        v, pos = _unpack(buf, pos)
        out[k] = v
    return out, pos


def unpackb(buf: bytes) -> Any:
    value, pos = _unpack(buf, 0)
    if pos != len(buf):
        raise ValueError("trailing bytes after the msgpack value")
    return value


# -------------------------------------------------------------------- files
def decompress(b: bytes) -> bytes:
    if b[:4] == ZSTD_MAGIC:
        import zstandard
        return zstandard.ZstdDecompressor().decompress(b)
    return zlib.decompress(b)


def leaf_name(tensor_name: str) -> str:
    """``state/model/embed/embed@[0:8192,0:1536]`` -> its leaf path
    ``state/model/embed/embed``."""
    return tensor_name.split("@", 1)[0]


class StepFile:
    """One ``.dsllm`` file: its footer, its tensors by leaf path."""

    def __init__(self, path: str):
        self.path = path
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            f.seek(size - TRAILER.size)
            n, magic = TRAILER.unpack(f.read(TRAILER.size))
            if magic != MAGIC:
                raise ValueError(f"{path}: bad magic {magic!r}")
            f.seek(size - TRAILER.size - n)
            footer = unpackb(f.read(n))
        self.tensors: Dict[str, Dict[str, Any]] = {
            leaf_name(t["name"]): t for t in footer["tensors"]}
        self.objects: Dict[str, Dict[str, Any]] = {
            o["name"]: o for o in footer["objects"]}
        self.meta: Dict[str, Any] = footer.get("meta") or {}

    def _read(self, offset: int, n: int) -> bytearray:
        b = bytearray(n)
        with open(self.path, "rb") as f:
            f.seek(offset)
            got = f.readinto(b)
        if got != n:
            raise ValueError(f"{self.path}: short read at {offset}")
        return b

    def raw_bytes(self, leaf: str) -> np.ndarray:
        t = self.tensors[leaf]
        if t["codec"] != "raw":
            raise ValueError(f"{leaf} is {t['codec']}, not raw")
        return np.frombuffer(self._read(t["offset"], t["nbytes"]),
                             dtype=np.uint8)

    def chunk_payloads(self, leaf: str) -> List[Tuple[int, int, bytes]]:
        """``(raw lo, raw hi, decompressed payload)`` of an encoded
        tensor, in raw order; the chunks must cover it without a gap."""
        t = self.tensors[leaf]
        out, covered = [], 0
        for off, comp, lo, hi, *_dig in sorted(t["enc_chunks"] or (),
                                              key=lambda c: c[2]):
            if lo != covered:
                raise ValueError(f"{leaf}: chunks leave a gap at {covered}")
            out.append((lo, hi, decompress(self._read(off, comp))))
            covered = hi
        if covered != t["nbytes"]:
            raise ValueError(f"{leaf}: chunks cover {covered} of "
                             f"{t['nbytes']} bytes")
        return out

    def xor_bytes(self, leaf: str) -> np.ndarray:
        """The XOR-domain bytes of a delta tensor."""
        out = np.empty(self.tensors[leaf]["nbytes"], dtype=np.uint8)
        for lo, hi, payload in self.chunk_payloads(leaf):
            if len(payload) != hi - lo:
                raise ValueError(f"{leaf}: delta chunk of {len(payload)} "
                                 f"bytes for [{lo}:{hi})")
            out[lo:hi] = np.frombuffer(payload, dtype=np.uint8)
        return out

    def int8_values(self, leaf: str) -> np.ndarray:
        """The float32 values of an ``int8q`` tensor."""
        vals = np.empty(self.tensors[leaf]["nbytes"] // 4, dtype=np.float32)
        for lo, hi, payload in self.chunk_payloads(leaf):
            rows, raw = struct.unpack_from("<II", payload, 0)
            if raw != hi - lo or rows != -(-raw // (4 * ROW_ELEMS)):
                raise ValueError(f"{leaf}: int8 header ({rows}, {raw}) for "
                                 f"[{lo}:{hi})")
            s = np.frombuffer(payload, np.float32, rows, 8)
            q = np.frombuffer(payload, np.int8, rows * ROW_ELEMS,
                              8 + 4 * rows).reshape(rows, ROW_ELEMS)
            vals[lo // 4:hi // 4] = (q.astype(np.float32)
                                     * s[:, None]).reshape(-1)[:raw // 4]
        return vals

    def object_bytes(self, name: str) -> bytes:
        o = self.objects[name]
        return self._read(o["offset"], o["nbytes"])


def step_files(root: str, step: int) -> List[StepFile]:
    sdir = os.path.join(root, f"global_step{step}")
    return [StepFile(os.path.join(sdir, f)) for f in sorted(os.listdir(sdir))
            if f.endswith(".dsllm")]


def committed(root: str, step: int) -> bool:
    """Whether the step's catalog manifest, written last, is there."""
    return os.path.isfile(os.path.join(root, ".catalog",
                                       f"step-{step:012d}.json"))


class Step:
    """A committed step: its files' tensors by leaf path, each delta
    resolved through its base steps."""

    def __init__(self, root: str, step: int,
                 cache: Optional[Dict[int, "Step"]] = None):
        self.step = step
        self.files = step_files(root, step)
        self.where = {leaf: f for f in self.files for leaf in f.tensors}
        self.objects = {name: f for f in self.files for name in f.objects}
        delta = self.files[0].meta.get("delta") if self.files else None
        self.base: Optional[Step] = None
        if delta and not delta.get("keyframe"):
            cache = {} if cache is None else cache
            b = delta["base_step"]
            self.base = cache.get(b) or Step(root, b, cache)
            cache[b] = self.base

    def codec(self, leaf: str) -> str:
        return self.where[leaf].tensors[leaf]["codec"].split("+", 1)[0]

    def tensor_bytes(self, leaf: str) -> np.ndarray:
        """The stored bytes of a raw or XOR-delta tensor, the delta
        folded onto its base step's bytes."""
        f = self.where[leaf]
        kind = self.codec(leaf)
        if kind == "raw":
            return f.raw_bytes(leaf)
        if kind == "xor":
            if self.base is None:
                raise ValueError(f"{leaf}: delta without a base step")
            return np.bitwise_xor(self.base.tensor_bytes(leaf),
                                  f.xor_bytes(leaf))
        raise ValueError(f"{leaf}: {kind} is not byte-exact")
