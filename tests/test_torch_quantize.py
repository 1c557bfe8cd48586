"""The port's int8 quantize/dequantize kernels and int8q codec held against
the JAX package.

* The plain PyTorch versions (what a CPU tensor dispatches to) are bit
  for bit ``repro.kernels.ref``'s oracles — scales, q, dequantized values
  and the payload digest — at 1, 3 and 257 rows and on the edge rows
  below, and the Pallas kernels in interpret mode at one 256-row tile
  (up to the jitted kernel's one-ulp scale, see that test).
* The port's ``encode_int8_block`` payload and digest are byte-identical
  to ``repro.core.codecs.encode_int8_block``'s, each package decodes the
  other's payload, and a corrupted payload raises ``CodecError`` in both.
* The segmented plain versions (what a CPU tensor dispatches to on the
  piece-fed path) give, for every segment of a piece, the payload and
  digest of ``repro``'s ``encode_int8_block`` of that chunk alone, and
  decode it as ``repro``'s ``decode_int8_block`` does.
* ``gpu``-marked tests hold the CUDA kernels against the plain versions
  on a card; they skip inside the test on a host without one.
"""

import re

import numpy as np
import pytest
import torch

import repro.core.codecs as jcodecs
from repro.kernels import fused as jfused
from repro.kernels import ref as jref
from repro_torch.core import codecs as tcodecs
from repro_torch.kernels import build
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quantize as tq
from repro_torch.kernels import variants

FLT_MIN = np.float32(2.0 ** -126)


def _rows(n_rows: int, seed: int) -> np.ndarray:
    """Seeded float32 rows with the edge rows of the int8 math mixed in:
    a zero row; a row whose amax is 127 (scale exactly 1.0) holding the
    half steps +-0.5 .. +-3.5 and +-amax; subnormals in a normal row; an
    all-subnormal row (read as zero, as the reference's flushing
    platforms do); a row whose scale would be subnormal (flushed to 0)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n_rows, 256)) * 10).astype(np.float32)
    edges = []
    zero = np.zeros(256, np.float32)
    edges.append(zero)
    half = zero.copy()
    half[:12] = [127, -127, 2.5, -2.5, 3.5, -3.5, 0.5, -0.5, 1.5, -1.5,
                 126.5, -126.5]
    edges.append(half)
    sub = x[0].copy()
    sub[:4] = [1e-40, -1e-41, FLT_MIN * 0.99, -FLT_MIN * 0.5]
    edges.append(sub)
    allsub = zero.copy()
    allsub[:3] = [1e-40, -3e-39, 1.4e-45]
    edges.append(allsub)
    tiny = zero.copy()
    tiny[:6] = [1e-36, 0, 1e-37, -1e-37, 1e-40, -1e-36]
    edges.append(tiny)
    for i, e in enumerate(edges[:n_rows]):
        x[(i * 7) % n_rows] = e
    return x


def _split(body: np.ndarray, n_rows: int):
    scales = body[:4 * n_rows].view(np.uint32)
    q = body[4 * n_rows:].view(np.int8).reshape(n_rows, 256)
    return scales, q


@pytest.mark.parametrize("n_rows", [1, 3, 5, 257])
def test_plain_quantize_matches_reference(n_rows):
    x = _rows(n_rows, seed=n_rows)
    q, scales, dig = jref.fused_quantize_checksum_ref(x, n_rows)
    body, got = tops.fused_quantize_int8(torch.from_numpy(x))
    assert body.numel() == tq.body_nbytes(n_rows)
    s_got, q_got = _split(body.numpy(), n_rows)
    np.testing.assert_array_equal(
        s_got, np.asarray(scales, np.float32).reshape(-1).view(np.uint32))
    np.testing.assert_array_equal(q_got, np.asarray(q))
    assert got == dig


@pytest.mark.parametrize("n_rows", [1, 3, 5, 257])
def test_plain_dequantize_matches_reference(n_rows):
    x = _rows(n_rows, seed=100 + n_rows)
    q, scales, _ = jref.fused_quantize_checksum_ref(x, n_rows)
    body, _ = tops.fused_quantize_int8(torch.from_numpy(x))
    want, want_dig = jref.fused_dequantize_checksum_ref(q, scales, n_rows)
    out, dig = tops.fused_dequantize_int8(body, n_rows)
    np.testing.assert_array_equal(out.numpy().view(np.uint32),
                                  np.asarray(want, np.float32).view(np.uint32))
    assert dig == want_dig


def test_plain_versions_match_pallas_interpret():
    """One 256-row tile of the Pallas kernels in interpret mode, 200 live
    rows (the tile's padded scale rows are masked out of its digest).

    Under ``jit`` XLA turns the kernel's ``amax / 127.0`` into a multiply
    by ``fl(1/127)``, so its scales may sit one ulp from the reference's
    IEEE quotient (``tests/test_fused_kernels.py`` calls this the repo's
    1-ULP jit convention). The port follows the codec's oracle, which
    divides; here the Pallas scales are checked to be that multiply, q is
    bit for bit the port's wherever the scales agree, and the Pallas
    digest and dequantize are bit for bit the port's over the Pallas
    kernel's own payload."""
    n_rows = 200
    x = np.zeros((256, 256), np.float32)
    x[:n_rows] = _rows(n_rows, seed=7)
    jq, js, jdig = jfused.quantize_checksum_int8(x, n_rows, interpret=True)
    jq = np.asarray(jq)[:n_rows]
    js = np.asarray(js, np.float32)[:n_rows].reshape(-1)
    body, _ = tq.quantize_checksum_plain(torch.from_numpy(x[:n_rows]))
    s_got, q_got = _split(body.numpy(), n_rows)
    live = np.where(np.abs(x[:n_rows]) < FLT_MIN, 0, x[:n_rows])
    amax = np.abs(live).max(axis=1)
    recip = amax * np.float32(1 / 127)
    recip = np.where(recip < FLT_MIN, 0, recip).astype(np.float32)
    np.testing.assert_array_equal(
        js.view(np.uint32),
        np.where(amax > 0, recip, np.float32(1)).astype(np.float32)
        .view(np.uint32))
    same = js.view(np.uint32) == s_got
    assert same.sum() > n_rows // 2
    assert np.abs(js.view(np.int32).astype(np.int64)
                  - s_got.view(np.int32).astype(np.int64)).max() <= 1
    np.testing.assert_array_equal(q_got[same], jq[same])
    jbody = torch.from_numpy(np.concatenate(
        [js.view(np.uint8), jq.reshape(-1).view(np.uint8)]))
    assert tq.body_digest(jbody) == int(np.asarray(jdig)[0, 0])
    qp = np.zeros((256, 256), np.int8)
    qp[:n_rows] = jq
    sp = np.ones((256, 1), np.float32)
    sp[:n_rows, 0] = js
    jout, jdig2 = jfused.dequantize_checksum_int8(qp, sp, n_rows,
                                                  interpret=True)
    out, dig2 = tq.dequantize_checksum_plain(jbody, n_rows)
    np.testing.assert_array_equal(
        out.numpy().view(np.uint32),
        np.asarray(jout)[:n_rows].view(np.uint32))
    assert dig2 == int(np.asarray(jdig2)[0, 0]) == int(np.asarray(jdig)[0, 0])


@pytest.mark.parametrize("n_values", [256, 3 * 256 + 17, 257 * 256 - 1])
def test_codec_payload_is_byte_identical(n_values):
    """Raw fp32 bytes whose tail is not a whole 1024-byte row."""
    raw = _rows(-(-n_values // 256), seed=n_values).reshape(-1)[:n_values] \
        .view(np.uint8)
    jpay, jdig = jcodecs.encode_int8_block(raw, with_digest=True)
    tpay, tdig = tcodecs.encode_int8_block(raw, True, "cpu")
    assert bytes(tpay) == jpay and tdig == jdig
    assert len(tpay) == tcodecs.int8_encoded_nbytes(raw.size) \
        == jcodecs.int8_encoded_nbytes(raw.size)
    assert tcodecs.encode_int8_block(raw, False, "cpu")[1] is None
    # each package decodes the other's payload, verified, to the same bytes
    want = jcodecs.decode_int8_block(jpay, 0, raw.size, expect_digest=jdig)
    got = tcodecs.decode_chunk_payload(tcodecs.INT8_CODEC, jpay, 0, raw.size,
                                       jdig, "cpu")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        jcodecs.decode_chunk_payload(jcodecs.INT8_CODEC, bytes(tpay), 0,
                                     raw.size, expect_digest=tdig), want)


@pytest.mark.parametrize("where", ["scale", "q", "header"])
def test_corrupt_payload_raises_in_both_packages(where):
    raw = _rows(3, seed=11).reshape(-1).view(np.uint8)
    payload, dig = tcodecs.encode_int8_block(raw, True, "cpu")
    bad = bytearray(bytes(payload))
    bad[{"scale": 8 + 5, "q": 8 + 12 + 300, "header": 0}[where]] ^= 0x04
    with pytest.raises(jcodecs.CodecError):
        jcodecs.decode_int8_block(bytes(bad), 0, raw.size, expect_digest=dig)
    with pytest.raises(tcodecs.CodecError):
        tcodecs.decode_int8_block(bytes(bad), 0, raw.size, dig, "cpu")


def test_codec_refuses_chained_and_unknown_codecs():
    with pytest.raises(tcodecs.CodecError, match="chained"):
        tcodecs.decode_chunk_payload(tcodecs.DELTA_CODEC, b"", 0, 0, None,
                                     "cpu")
    with pytest.raises(tcodecs.CodecError, match="unknown"):
        tcodecs.decode_chunk_payload("lz4q", b"", 0, 0, None, "cpu")


def test_cuda_wrappers_refuse_host_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        tq.quantize_checksum_cuda(torch.zeros(2, 256))
    with pytest.raises(ValueError, match="CUDA"):
        tq.dequantize_checksum_cuda(torch.zeros(260, dtype=torch.uint8), 1)
    with pytest.raises(ValueError, match="rows"):
        tops.fused_quantize_int8(torch.zeros(2, 255))
    with pytest.raises(ValueError, match="body"):
        tops.fused_dequantize_int8(torch.zeros(259, dtype=torch.uint8), 1)


def test_quantize_entry_points_are_in_the_library():
    src = build.SOURCES[0].read_text()
    for kern in (tq.QUANT_KERNEL, tq.DEQUANT_KERNEL):
        assert kern.symbol in build.SIGNATURES
        assert f'extern "C" int {kern.symbol}(' in src


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("n_rows", [1, 3, 257, 4096])
def test_cuda_quantize_matches_plain(n_rows):
    _cuda_or_skip()
    x = torch.from_numpy(_rows(n_rows, seed=n_rows)).cuda()
    body, dig = tops.fused_quantize_int8(x)
    pbody, pdig = tq.quantize_checksum_plain(x)
    assert torch.equal(body, pbody) and dig == pdig
    out, odig = tops.fused_dequantize_int8(body, n_rows)
    pout, podig = tq.dequantize_checksum_plain(body, n_rows)
    assert torch.equal(out.view(torch.int32), pout.view(torch.int32))
    assert odig == podig == pdig


@pytest.mark.gpu
def test_cuda_codec_matches_reference():
    _cuda_or_skip()
    raw = _rows(9, seed=3).reshape(-1)[:9 * 256 - 5].view(np.uint8)
    jpay, jdig = jcodecs.encode_int8_block(raw, with_digest=True)
    tpay, tdig = tcodecs.encode_int8_block(raw, True, "cuda")
    assert bytes(tpay) == jpay and tdig == jdig
    np.testing.assert_array_equal(
        tcodecs.decode_int8_block(jpay, 0, raw.size, jdig, "cuda"),
        jcodecs.decode_int8_block(jpay, 0, raw.size, expect_digest=jdig))


#: chunks' raw bytes of a piece: one chunk; 16; 16 and a 17th of one row;
#: a 1-row last segment; a ragged raw tail; unequal sizes; a tensor
#: smaller than one row (4 and 1,020 bytes)
SEGMENT_CASES = {
    "one": (3 * 1024,), "sixteen": (2 * 1024,) * 16,
    "seventeen": (2 * 1024,) * 16 + (1024,),
    "one_row_last": (2 * 1024,) * 3 + (1024,),
    "ragged_tail": (2 * 1024, 2 * 1024, 1000),
    "unequal": (1024, 5 * 1024, 2 * 1024, 3 * 1024 - 20),
    "tiny": (4,), "short_row": (1020,)}


def _piece(sizes, seed):
    """Seeded raw bytes of a piece of chunks of ``sizes``, the edge rows of
    :func:`_rows` in them, and its layout."""
    starts, valid = variants.int8_layout(sizes)
    raw = _rows(starts[-1], seed).reshape(-1).view(np.uint8)[:valid]
    return raw, starts, valid


@pytest.mark.parametrize("case", sorted(SEGMENT_CASES))
def test_plain_segments_match_reference(case):
    """Each segment's payload and digest are ``repro``'s encode of that
    chunk alone; the segmented decode gives ``repro``'s decode of each
    payload and the same digests."""
    sizes = SEGMENT_CASES[case]
    raw, starts, valid = _piece(sizes, seed=len(sizes))
    pay, dig = tops.fused_quantize_int8_segments(torch.from_numpy(raw),
                                                 valid, starts)
    offs = tq.segment_offsets(starts)
    assert pay.numel() == offs[-1] and dig.numel() == len(sizes)
    digs = dig.numpy().view(np.uint32)
    rows, odig = tops.fused_dequantize_int8_segments(pay, starts)
    out = rows.numpy().reshape(-1).view(np.uint8)
    lo = 0
    for s, n in enumerate(sizes):
        jpay, jdig = jcodecs.encode_int8_block(raw[lo:lo + n],
                                               with_digest=True)
        assert pay[offs[s]:offs[s + 1]].numpy().tobytes() == jpay
        assert digs[s] == jdig
        np.testing.assert_array_equal(
            out[1024 * starts[s]:1024 * starts[s] + n],
            jcodecs.decode_int8_block(jpay, lo, lo + n, expect_digest=jdig))
        lo += n
    assert torch.equal(odig, dig)


@pytest.mark.parametrize("starts,valid", [
    ([1, 2], 1024), ([0, 0, 1], 1024), ([0, 2, 1], 1024),
    (list(range(34)), 33 * 1024), ([0, 2], 1024), ([0, 2], 2049),
    ([0], 0)])
def test_segment_tables_are_checked(starts, valid):
    """A table not starting at 0, an empty or backward segment, more than
    32 segments, valid bytes that do not end in the last row, no segment:
    refused before any launch, on every device."""
    x = torch.zeros(4096, dtype=torch.uint8)
    with pytest.raises(ValueError):
        tq.quantize_checksum_segments_plain(x, valid, starts)
    with pytest.raises(ValueError):
        tq.quantize_checksum_segments_cuda(x, valid, starts)


def test_segmented_wrappers_write_into_given_outputs():
    raw, starts, valid = _piece((1024, 2048, 100), seed=5)
    x = torch.from_numpy(raw)
    offs = tq.segment_offsets(starts)
    out = torch.empty(offs[-1], dtype=torch.uint8)
    dig = torch.empty(3, dtype=torch.int32)
    pay, d = tops.fused_quantize_int8_segments(x, valid, starts, out, dig)
    assert pay is out and d is dig
    rows = torch.empty((starts[-1], 256))
    got, d2 = tops.fused_dequantize_int8_segments(out, starts, rows)
    assert got is rows and torch.equal(d2, dig)
    with pytest.raises(ValueError, match="payloads"):
        tops.fused_quantize_int8_segments(x, valid, starts, out[1:])
    with pytest.raises(ValueError, match="CUDA"):
        tq.dequantize_checksum_segments_cuda(out, starts)


@pytest.mark.parametrize("name", sorted(variants.INT8_ABLATIONS))
def test_int8_ablations_apply_to_the_kernel_source(name):
    """Each variant of ``python -m repro_torch.kernels.variants int8``
    edits ``ckpt_kernels.cu``; only ``int8`` is the shipped pair, and all
    four int8 entries stay."""
    src = (build.CSRC / variants.STREAM).read_text()
    out = variants.variant_source(variants.INT8_ABLATIONS[name],
                                  variants.STREAM)
    assert (out == src) == (name == "int8")
    for sym in ("ckpt_quantize_checksum_int8",
                "ckpt_dequantize_checksum_int8",
                "ckpt_quantize_checksum_int8_segments",
                "ckpt_dequantize_checksum_int8_segments"):
        assert out.count(f'extern "C" int {sym}(') == 1
    # clusters of at most 16 blocks: the launch allows those past 8
    for sym in ("kQuantCluster", "kDequantCluster"):
        assert re.search(rf"constexpr int {sym} = (8|16);", out)
    pair = out[out.index("// -------------------------------------------"
                         "--------- segmented int8 pair"):
               out.index("}  // namespace")]
    assert ("block_fold(" in pair) == (name == "atomic_loop")


@pytest.mark.gpu
@pytest.mark.parametrize("sizes", variants.INT8_CASES,
                         ids=lambda t: f"{len(t)}x{sorted(set(t))}")
def test_cuda_segments_match_plain(sizes):
    """Payloads, digests and rows bit for bit at every layout the tool
    checks (the 64 MiB piece included), with the edge values, zero rows
    and ties in the first and the last segment."""
    _cuda_or_skip()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(len(sizes))
    x, starts, valid = variants.int8_inputs(torch, sizes, gen)
    pay, dig = tops.fused_quantize_int8_segments(x, valid, starts)
    ppay, pdig = tq.quantize_checksum_segments_plain(x, valid, starts)
    assert torch.equal(pay, ppay) and torch.equal(dig, pdig)
    rows, odig = tops.fused_dequantize_int8_segments(pay, starts)
    prows, podig = tq.dequantize_checksum_segments_plain(pay, starts)
    assert torch.equal(rows.view(torch.int32), prows.view(torch.int32))
    assert torch.equal(odig, podig) and torch.equal(odig, dig)


@pytest.mark.gpu
def test_cuda_segments_write_digests_whole():
    """Two calls into the same outputs give the same digests: nothing is
    accumulated, so nothing needs zeroing."""
    _cuda_or_skip()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    x, starts, valid = variants.int8_inputs(torch, (8192,) * 5 + (300,), gen)
    pay, dig = tq.quantize_checksum_segments_cuda(x, valid, starts)
    first = dig.clone()
    tq.quantize_checksum_segments_cuda(x, valid, starts, pay, dig)
    assert torch.equal(dig, first)
    rows, odig = tq.dequantize_checksum_segments_cuda(pay, starts)
    tq.dequantize_checksum_segments_cuda(pay, starts, rows, odig)
    assert torch.equal(odig, first)


@pytest.mark.gpu
def test_cuda_segments_on_two_lane_streams():
    """Two lanes encoding different pieces at once, each on its own
    stream, both come out right."""
    import threading
    _cuda_or_skip()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    inputs = [variants.int8_inputs(torch, (4 << 20,) * k + (5000,), gen)
              for k in (16, 9)]
    torch.cuda.synchronize()
    got = [None, None]

    def lane(i):
        x, starts, valid = inputs[i]
        with tops.lane_stream(x.device) as st:
            for _ in range(5):
                pay, dig = tops.fused_quantize_int8_segments(x, valid, starts)
            st.synchronize()
        got[i] = (pay, dig)

    threads = [threading.Thread(target=lane, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for (x, starts, valid), (pay, dig) in zip(inputs, got):
        ppay, pdig = tq.quantize_checksum_segments_plain(x, valid, starts)
        assert torch.equal(pay, ppay) and torch.equal(dig, pdig)


@pytest.mark.gpu
@pytest.mark.parametrize("n_bytes", [4, 1022, 9 * 1024 - 20, 4 << 20])
def test_cuda_codec_matches_cpu(n_bytes):
    """``encode_int8_block`` on the card equals it on the CPU byte for
    byte, and each decodes the other's payload to the same bytes."""
    _cuda_or_skip()
    raw = _rows(-(-n_bytes // 1024), seed=n_bytes).reshape(-1) \
        .view(np.uint8)[:n_bytes]
    cpay, cdig = tcodecs.encode_int8_block(raw, True, "cpu")
    gpay, gdig = tcodecs.encode_int8_block(raw, True, "cuda")
    assert bytes(gpay) == bytes(cpay) and gdig == cdig
    np.testing.assert_array_equal(
        tcodecs.decode_int8_block(cpay, 0, n_bytes, cdig, "cuda"),
        tcodecs.decode_int8_block(gpay, 0, n_bytes, gdig, "cpu"))
