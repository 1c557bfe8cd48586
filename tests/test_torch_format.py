"""The port's on-disk format held against the JAX package's.

* The pure-Python footer codec is byte-identical to ``msgpack.packb(obj,
  use_bin_type=True)`` and reads what ``msgpack.unpackb`` reads.
* ``StreamingFileChecksum`` and ``file_checksum`` give the JAX package's
  values on the same bytes.
* Each package's ``FileReader`` reads the other's ``FileWriter`` output:
  raw tensors (bfloat16 included), XOR-delta chunks with digests, legacy
  4-tuple footers, pickle and msgpack objects.
* Delta encode is bit-exact against the JAX package's; ``int8q`` payloads
  are refused, never misread.
"""

import dataclasses
import os
import pickle

import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch

from repro.core import codecs as jcodecs
from repro.core import layout as jlayout
from repro.core.reduction import _compress as j_compress
from repro.core.reduction import _decompress as j_decompress
from repro.storage.file_format import StreamingFileChecksum as JStreaming
from repro.storage.manifest import file_checksum as j_file_checksum
from repro_torch.core import codecs as tcodecs
from repro_torch.core import layout as tlayout
from repro_torch.core import msgpack_lite
from repro_torch.core.reduction import _compress as t_compress
from repro_torch.core.reduction import _decompress as t_decompress
from repro_torch.storage.file_format import StreamingFileChecksum
from repro_torch.storage.manifest import PIECE_CHUNKS, file_checksum

FOOTER_LIKE = {
    "version": 1,
    "tensors": [{"name": "state/model/embed/embed@[0:512,0:256]",
                 "offset": 0, "nbytes": 262144, "dtype": "bfloat16",
                 "shape": (512, 256), "global_shape": (512, 256),
                 "index": ((0, 512), (0, 256)), "checksum": 4294967295,
                 "codec": "raw", "enc_chunks": None,
                 "raw_chunks": [(0, 262144, 123456789)]}],
    "objects": [{"name": "state/meta/step", "offset": 266240,
                 "nbytes": 21, "codec": "pickle"}],
    "meta": {"rank": 0, "delta": {"keyframe": False, "base_step": 2,
                                  "chain_depth": 1, "codec": "xor+zstd"}},
}

PACK_CASES = [
    None, True, False, 0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1,
    2**32, 2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2**31,
    -2**31 - 1, -2**63, 0.5, -1e300, "", "a" * 31, "a" * 32, "b" * 255,
    "c" * 256, "d" * 70_000, "ü€", b"", b"x" * 255, b"x" * 256,
    b"y" * 70_000, list(range(15)), list(range(16)), list(range(70_000)),
    {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
    {str(i): i for i in range(70_000)}, FOOTER_LIKE,
]


@pytest.mark.parametrize("obj", PACK_CASES,
                         ids=[f"case{i}" for i in range(len(PACK_CASES))])
def test_msgpack_lite_is_byte_identical(obj):
    want = msgpack.packb(obj, use_bin_type=True)
    assert msgpack_lite.packb(obj) == want
    assert msgpack_lite.unpackb(want) == msgpack.unpackb(want, raw=False)


def test_msgpack_lite_refuses_unsupported_values():
    with pytest.raises(TypeError):
        msgpack_lite.packb({"x": np.int64(3)})
    with pytest.raises(ValueError):
        msgpack_lite.unpackb(b"\x92\x01")            # truncated array
    with pytest.raises(ValueError):
        msgpack_lite.unpackb(b"\xc1")                # never-used byte


@pytest.mark.parametrize("chunk", [64, 4096])
def test_streaming_checksum_matches_reference(chunk):
    rng = np.random.default_rng(chunk)
    ours, theirs = StreamingFileChecksum(chunk), JStreaming(chunk)
    for off in (0, 3, 17, 1000, 4093, 9000):
        data = rng.integers(0, 256, 333, dtype=np.uint8)
        assert ours.contribution(off, data) == theirs.contribution(off, data)
        ours.update(off, data.tobytes())
        theirs.update(off, data.tobytes())
    assert ours.value == theirs.value


#: a piece of file_checksum at 4,096-byte chunks
SMALL_PIECE = PIECE_CHUNKS * 4096


@pytest.mark.parametrize("size,chunk", [
    *(pytest.param(n, None, id=str(n)) for n in (0, 1, 4 << 20,
                                                 (4 << 20) + 3)),
    *(pytest.param(n, 4096, id=f"chunk4096-{n}")
      for n in (0, 1, SMALL_PIECE, 3 * SMALL_PIECE + 5, SMALL_PIECE - 1,
                SMALL_PIECE + 1))])
def test_file_checksum_matches_reference(tmp_path, size, chunk):
    """At the default 4 MiB chunk, and at 4,096-byte chunks around the
    boundaries of the 16-chunk pieces the file is read in: one piece,
    three and a byte tail, a piece less or more one byte."""
    p = tmp_path / "f.bin"
    p.write_bytes(np.random.default_rng(size).integers(
        0, 256, size, dtype=np.uint8).tobytes())
    kw = {} if chunk is None else {"chunk_bytes": chunk}
    assert file_checksum(str(p), "cpu", **kw) == j_file_checksum(str(p), **kw)


def test_file_checksum_takes_whole_words_of_chunks(tmp_path):
    p = tmp_path / "f.bin"
    p.write_bytes(b"abc")
    with pytest.raises(ValueError, match="multiple of 16"):
        file_checksum(str(p), "cpu", chunk_bytes=4100)


@pytest.mark.gpu
def test_cuda_file_checksum_matches_cpu(tmp_path):
    """Two pieces and a byte tail through the kernel, each piece one
    launch, equal to the plain version's result."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import checksum as tchecksum
    p = tmp_path / "f.bin"
    p.write_bytes(np.random.default_rng(2).integers(
        0, 256, 2 * SMALL_PIECE + 7, dtype=np.uint8).tobytes())
    before = tchecksum.KERNEL.launches
    got = file_checksum(str(p), "cuda", chunk_bytes=4096)
    assert tchecksum.KERNEL.launches - before == 3
    assert got == file_checksum(str(p), "cpu", chunk_bytes=4096)


def test_compression_frames_read_across_packages():
    data = np.random.default_rng(0).integers(0, 4, 50_000, np.uint8) \
        .tobytes()
    assert t_decompress(j_compress(data)) == data
    assert j_decompress(t_compress(data)) == data


@pytest.mark.parametrize("nbytes", [1, 7, 4096, 70_003])
def test_delta_encode_matches_reference(nbytes):
    rng = np.random.default_rng(nbytes)
    cur = rng.integers(0, 256, nbytes, dtype=np.uint8)
    prev = rng.integers(0, 256, nbytes, dtype=np.uint8)
    d_want, dig_want = jcodecs.encode_delta_chunk(cur, prev, with_digest=True)
    d, dig = tcodecs.encode_delta_chunk(cur, prev, True, "cpu")
    np.testing.assert_array_equal(d, d_want)
    assert dig == dig_want
    d2, none = tcodecs.encode_delta_chunk(cur, prev, False, "cpu")
    np.testing.assert_array_equal(d2, d_want)
    assert none is None
    assert tcodecs.payload_digest(d, "cpu") == jcodecs.payload_digest(d)


def test_int8q_payloads_are_refused():
    """A malformed int8q payload is refused by the port's decoder, never
    misread; a chained codec never decodes standalone."""
    with pytest.raises(tcodecs.CodecError, match="declares 0 raw bytes"):
        tcodecs.decode_chunk_payload("int8q+zstd", b"\0" * 16, 0, 8, None,
                                     "cpu")
    with pytest.raises(tcodecs.CodecError, match="shorter than its header"):
        tcodecs.decode_chunk_payload("int8q+zstd", b"\0" * 4, 0, 8, None,
                                     "cpu")
    with pytest.raises(tcodecs.CodecError, match="chained"):
        tcodecs.decode_chunk_payload("xor+zstd", b"", 0, 0, None, "cpu")
    assert tcodecs.is_chained_codec(tcodecs.DELTA_CODEC)
    assert not tcodecs.is_chained_codec(tcodecs.INT8_CODEC)
    assert (tcodecs.DELTA_CODEC, tcodecs.INT8_CODEC) == \
        (jcodecs.DELTA_CODEC, jcodecs.INT8_CODEC)


def _write(mod, path, *, digest_fn, legacy: bool = False):
    """One file with a bf16 and an fp32 raw tensor, a two-chunk XOR-delta
    tensor, a pickle and a msgpack object — through ``mod``'s writer."""
    rng = np.random.default_rng(11)
    bf = rng.standard_normal((16, 8)).astype(ml_dtypes.bfloat16)
    f32 = rng.standard_normal((5,)).astype(np.float32)
    delta = rng.integers(0, 256, 1001, dtype=np.uint8)
    layout = mod.FileLayout.plan([
        ("bf", bf.nbytes, "bfloat16", bf.shape, bf.shape,
         ((0, 16), (0, 8))),
        ("f32", f32.nbytes, "float32", f32.shape, None, None)])
    w = mod.FileWriter(str(path), layout, track_checksum=True)
    for t, arr in zip(layout.tensors, (bf, f32)):
        b = arr.reshape(-1).view(np.uint8)
        w.write_at(t.offset, b)
        w.record_raw_chunk(t.name, 0, b.size, digest_fn(b))
    w.declare_encoded_tensor("d", dtype="uint8", shape=(1001,),
                             nbytes=1001, codec="xor+zstd")
    for lo, hi in ((600, 1001), (0, 600)):
        part = delta[lo:hi]
        w.append_encoded_chunk("d", j_compress(part.tobytes()), lo, hi,
                               digest=None if legacy else digest_fn(part))
    w.append_object("obj/pickle", pickle.dumps({"a": [1, 2]}))
    w.append_object("obj/msgpack", msgpack.packb({"b": "c"},
                                                 use_bin_type=True),
                    codec="msgpack")
    w.set_meta("rank", 0)
    w.finalize()
    return bf, f32, delta, w.file_checksum


@pytest.mark.parametrize("direction", ["repro->port", "port->repro"])
def test_files_read_across_packages(tmp_path, direction):
    path = tmp_path / "rank00000.dsllm"
    if direction == "repro->port":
        writer, reader = jlayout, tlayout
        digest = jcodecs.payload_digest
    else:
        writer, reader = tlayout, jlayout
        digest = (lambda b: tcodecs.payload_digest(b, "cpu"))
    bf, f32, delta, streamed = _write(writer, path, digest_fn=digest)
    assert streamed == j_file_checksum(str(path)) \
        == file_checksum(str(path), "cpu")
    rd = reader.FileReader(str(path))
    got_bf = rd.read_tensor("bf")
    if reader is tlayout:   # bfloat16 comes back as its uint16 storage
        np.testing.assert_array_equal(got_bf, bf.view(np.uint16))
        got_d = rd.read_encoded_delta("d", "cpu")
        assert rd.locate_corrupt_chunks("cpu") == []
    else:
        np.testing.assert_array_equal(got_bf.view(np.uint16),
                                      bf.view(np.uint16))
        got_d = rd.read_encoded_delta("d")
        assert rd.locate_corrupt_chunks() == []
    np.testing.assert_array_equal(rd.read_tensor("f32"), f32)
    np.testing.assert_array_equal(got_d, delta)
    assert rd.read_object("obj/pickle") == {"a": [1, 2]}
    assert rd.read_object("obj/msgpack") == {"b": "c"}
    assert rd.tensors["bf"].raw_chunks[0][2] == digest(
        bf.reshape(-1).view(np.uint8))
    # both packages write the same footer for the same content
    other = tmp_path / "other.dsllm"
    _write(reader, other, digest_fn=digest)
    assert jlayout.FileReader(str(other)).footer == \
        tlayout.FileReader(str(path)).footer


def test_legacy_four_tuple_chunks_and_tampering(tmp_path):
    path = tmp_path / "rank00000.dsllm"
    _write(jlayout, path, digest_fn=jcodecs.payload_digest, legacy=True)
    rd = tlayout.FileReader(str(path))
    assert all(len(c) == 5 and c[4] is None
               for c in rd.tensors["d"].enc_chunks)
    rd.read_encoded_delta("d", "cpu")
    # flip one byte of a digested raw chunk: located, not silently read
    _write(jlayout, path, digest_fn=jcodecs.payload_digest)
    e = tlayout.FileReader(str(path)).tensors["bf"]
    with open(path, "r+b") as f:
        f.seek(e.offset + 3)
        b = f.read(1)
        f.seek(e.offset + 3)
        f.write(bytes([b[0] ^ 0xFF]))
    assert tlayout.FileReader(str(path)).locate_corrupt_chunks("cpu") == \
        ["bf raw chunk [0:256)"]


def test_tampered_delta_chunk_fails_its_digest(tmp_path):
    path = tmp_path / "rank00000.dsllm"
    _write(tlayout, path,
           digest_fn=lambda b: tcodecs.payload_digest(b, "cpu"))
    rd = tlayout.FileReader(str(path))
    off, nb, lo, hi, dig = rd.tensors["d"].enc_chunks[0]
    bad = dataclasses.replace(
        rd.tensors["d"],
        enc_chunks=[(off, nb, lo, hi, (dig + 1) & 0xFFFFFFFF)]
        + list(rd.tensors["d"].enc_chunks[1:]))
    rd.tensors["d"] = bad
    with pytest.raises(ValueError, match="digest mismatch"):
        rd.read_encoded_delta("d", "cpu")


def test_reader_rejects_truncated_files(tmp_path):
    p = tmp_path / "short.dsllm"
    p.write_bytes(b"abc")
    with pytest.raises(ValueError, match="too small"):
        tlayout.FileReader(str(p))
    p.write_bytes(b"\0" * 64)
    with pytest.raises(ValueError, match="bad magic"):
        tlayout.FileReader(str(p))
    assert os.path.getsize(p) == 64
