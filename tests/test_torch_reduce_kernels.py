"""The port's offline-reduction kernels held against the JAX package:
``downcast_bf16``, ``quantize_int8``, ``dequantize_int8``, ``delta_f32``
and ``xor_fold_checksum_u32``.

* Each plain PyTorch version (what a CPU tensor dispatches to) is bit for
  bit the Pallas kernel in interpret mode through ``repro.kernels.ops`` and
  the oracle in ``repro.kernels.ref``, on seeded values with the edge
  values the reference pins placed among them (NaNs, infinities,
  subnormals, rounding ties, signed zeros). Tolerance 0: bits are compared
  through uint16/uint32 views.
* Two places where the reference's own pieces disagree, each pinned:
  ``ops.quantize_int8`` (jitted) multiplies by ``fl(1/127)`` where the
  oracle divides (the repo's 1-ulp jit convention, ``tests/
  test_fused_kernels.py:118``), and ``ref.dequantize_int8_ref`` keeps the
  subnormal scales the Pallas kernel flushes. The port follows the oracle
  for the quantizer (it shares the fused encode's math) and the kernel for
  the dequantizer.
* The dispatch refuses other devices and other shapes; the ``*_cuda``
  entry points refuse host tensors.
* ``gpu``-marked tests hold the CUDA kernels against the plain versions
  on a card; they skip inside the test on a host without one.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import build, delta, fused  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import quantize as tq  # noqa: E402
from test_torch_quantize import _rows  # noqa: E402

F32 = np.float32


def _f32(bits) -> np.ndarray:
    return np.asarray(bits, np.uint32).view(F32)


#: fp32 values whose bf16 the reference pins: subnormals kept (1e-40 ->
#: 0x0001, 1.17e-38 -> 0x007f), every NaN to sign | 0x7fc0 (quiet,
#: signalling, with payload), +-inf, the largest float rounding to inf,
#: ties to even (0x3f808000 down, 0x3f818000 up), signed zero
DOWNCAST_EDGES = np.concatenate([
    np.array([1e-40, 1.17e-38, -1e-40, 0.0, -0.0], F32),
    _f32([0x7FC00000, 0xFFC00000, 0x7F800001, 0x7FA00000, 0xFF800001,
          0x7FFFFFFF, 0xFFFFFFFF, 0x7F800000, 0xFF800000, 0x7F7FFFFF,
          0xFF7FFFFF, 0x3F808000, 0x3F818000, 0x3F80FFFF, 0x80000001,
          0x7F7F8000, 0x00008000, 0x00018000])])
#: scales of the dequantize edge rows: subnormal (flushed to a zero of
#: its sign: 1e-38, -1e-40, 1e-45), the least normals kept (2e-38,
#: 2^-126), +-inf (0 * inf is NaN), a signalling NaN, zeros of each sign
DEQUANT_EDGE_SCALES = np.concatenate([
    np.array([1e-38, 2e-38, -1e-40, 1e-45, 2.0 ** -126, np.inf, -np.inf,
              0.0, -0.0], F32), _f32([0x7FA00001])])
#: (cur, prev) pairs of delta_f32 the reference pins: subnormal results
#: and inputs flushed to zeros of their sign, signed zeros, inf - inf,
#: NaN propagation, and ordinary values
DELTA_EDGES = [(1.2e-38, 1.5e-38), (1e-40, 0.0), (0.0, 1e-40),
               (-1e-40, 0.0), (-1e-40, 1e-40), (0.0, -0.0), (-0.0, 0.0),
               (-1e-40, -0.0), (np.inf, np.inf), (np.inf, -np.inf),
               (np.nan, 1.0), (1.0, np.nan), (-np.nan, 1.0), (3.0, 1.0),
               (1e-38, 5e-39), (2e-38, 1e-38), (3.4e38, -3.4e38)]


def _downcast_input(rows: int, cols: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, cols)) * 100).astype(F32)
    flat = x.reshape(-1)
    idx = rng.choice(flat.size, DOWNCAST_EDGES.size, replace=False)
    flat[idx] = DOWNCAST_EDGES
    flat[:DOWNCAST_EDGES.size] = DOWNCAST_EDGES
    return x


def _u16(a) -> np.ndarray:
    return np.asarray(a).view(np.uint16)


def _u32(a) -> np.ndarray:
    return np.asarray(a, F32).view(np.uint32)


@pytest.mark.parametrize("shape", [(256, 256), (256, 512)])
def test_plain_downcast_matches_reference(shape):
    x = _downcast_input(*shape, seed=shape[1])
    got = tops.downcast_bf16(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == shape
    bits = got.view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(
        bits, _u16(jops.downcast_bf16(x, interpret=True)))
    np.testing.assert_array_equal(bits, _u16(jref.downcast_bf16_ref(x)))
    # the pinned edges, spelled out
    np.testing.assert_array_equal(
        bits.reshape(-1)[:7], [0x0001, 0x007F, 0x8001, 0, 0x8000, 0x7FC0,
                               0xFFC0])
    assert set(bits.reshape(-1)[5:12].tolist()) == {0x7FC0, 0xFFC0}


@pytest.mark.parametrize("n_rows", [256, 512])
def test_plain_quantize_int8_matches_reference(n_rows):
    """q and scales bit for bit the oracle's and the port's fused encode
    body's; against the jitted Pallas kernel, the scales are its
    ``amax * fl(1/127)`` (within one ulp of the quotient) and q agrees on
    every row whose scale agrees."""
    x = _rows(n_rows, seed=n_rows)
    x[1] = 0
    x[1, :3] = [-1e-40, 1e-40, 2.0]   # the reference's probe: 0, 0, 127
    x[2, 5] = np.nan                  # scale 1.0, q = clip(round(x))
    x[3, [7, 9]] = [np.inf, -np.inf]  # scale inf, q = 0
    x[4, :2] = [np.nan, np.inf]
    q, s = tops.quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and tuple(q.shape) == (n_rows, 256)
    assert s.dtype == torch.float32 and tuple(s.shape) == (n_rows, 1)
    q, s = q.numpy(), s.numpy()
    assert q[1, :3].tolist() == [0, 0, 127] \
        and s[1, 0] == F32(2) / F32(127)
    assert s[[2, 3, 4], 0].tolist() == [1.0, np.inf, 1.0]
    rq, rs = jref.quantize_int8_ref(x)
    np.testing.assert_array_equal(q, np.asarray(rq))
    np.testing.assert_array_equal(_u32(s), _u32(rs))
    body, _ = tq.quantize_checksum_plain(torch.from_numpy(x))
    body = body.numpy()
    np.testing.assert_array_equal(body[:4 * n_rows].view(np.uint32),
                                  _u32(s).reshape(-1))
    np.testing.assert_array_equal(body[4 * n_rows:].view(np.int8),
                                  q.reshape(-1))
    jq, js = jops.quantize_int8(x, interpret=True)
    jq, js = np.asarray(jq), _u32(js).reshape(-1)
    live = np.where(np.abs(x) < F32(2.0 ** -126), 0, x)
    amax = np.abs(live).max(axis=1)    # NaN where a row holds one
    recip = (amax * F32(1 / 127)).astype(F32)
    recip = np.where(recip < F32(2.0 ** -126), 0, recip).astype(F32)
    np.testing.assert_array_equal(
        js, np.where(amax > 0, recip, F32(1)).astype(F32).view(np.uint32))
    same = js == _u32(s).reshape(-1)
    assert same.sum() > n_rows // 2
    np.testing.assert_array_equal(q[same], jq[same])


def test_plain_dequantize_int8_matches_reference():
    """Seeded q in [-128, 127] with seeded scales, the edge scales of
    :data:`DEQUANT_EDGE_SCALES` on the first rows. The Pallas kernel
    flushes a subnormal scale and a subnormal product to a zero of its
    sign; the oracle ``ref.dequantize_int8_ref`` does not, so it is held
    only on the rows whose scales are normal."""
    rng = np.random.default_rng(5)
    q = rng.integers(-128, 128, (256, 256), dtype=np.int8)
    q[:, :3] = [1, -1, 0]
    scales = (np.abs(rng.standard_normal((256, 1))) * 0.1).astype(F32)
    k = DEQUANT_EDGE_SCALES.size
    scales[:k, 0] = DEQUANT_EDGE_SCALES
    got = tops.dequantize_int8(torch.from_numpy(q), torch.from_numpy(scales))
    assert got.dtype == torch.float32 and tuple(got.shape) == (256, 256)
    bits = _u32(got.numpy())
    np.testing.assert_array_equal(
        bits, _u32(jops.dequantize_int8(q, scales, interpret=True)))
    np.testing.assert_array_equal(
        bits[k:], _u32(jref.dequantize_int8_ref(q[k:], scales[k:])))
    # 1 * 1e-38 is +0, -1 * 1e-38 is -0; 2e-38 is kept
    assert bits[0, :3].tolist() == [0, 0x80000000, 0]
    assert got[1, 0].item() == F32(2e-38)


@pytest.mark.parametrize("n", [65_536, 65_536 + 5])
def test_plain_delta_f32_matches_reference(n):
    """Compared on the first n values: the reference pads to 65,536."""
    rng = np.random.default_rng(n)
    cur = rng.standard_normal(n).astype(F32)
    prev = (cur + rng.standard_normal(n) * 1e-3).astype(F32)
    for i, (a, b) in enumerate(DELTA_EDGES):
        cur[7 * i], prev[7 * i] = a, b
    got = tops.delta_f32(torch.from_numpy(cur), torch.from_numpy(prev))
    assert got.dtype == torch.float32 and tuple(got.shape) == (n,)
    bits = _u32(got.numpy())
    np.testing.assert_array_equal(
        bits, _u32(jops.delta_f32(cur, prev, interpret=True))[:n])
    np.testing.assert_array_equal(bits, _u32(jref.delta_f32_ref(cur, prev)))
    # the pinned signs of flushed zeros
    assert bits[[0, 7, 14, 21, 28]].tolist() == [0x80000000, 0, 0,
                                                 0x80000000, 0x80000000]
    assert bits[49] == 0   # -1e-40 - -0.0


@pytest.mark.parametrize("n_words", [65_536, 65_536 + 5, 131_072])
def test_plain_xor_fold_matches_reference(n_words):
    rng = np.random.default_rng(n_words)
    base = rng.integers(0, 2**32, n_words, dtype=np.uint32)
    dlt = rng.integers(0, 2**32, n_words, dtype=np.uint32)
    dlt[::3] = 0
    b = torch.from_numpy(base.view(np.int32).copy())
    d = torch.from_numpy(dlt.view(np.int32).copy())
    folded, dig = tops.fused_xor_fold(b, d)
    jf, jdig = jops.fused_xor_fold(base, dlt, interpret=True)
    np.testing.assert_array_equal(folded.numpy().view(np.uint32),
                                  np.asarray(jf)[:n_words])
    assert dig == int(jdig)
    rf, rdig = jref.fused_xor_fold_checksum_ref(base, dlt)
    np.testing.assert_array_equal(folded.numpy().view(np.uint32), rf)
    assert dig == rdig == tops.checksum(d)


def test_wrappers_refuse_other_devices_and_shapes():
    meta = {"device": "meta"}
    with pytest.raises(ValueError, match="no checkpoint kernel"):
        tops.downcast_bf16(torch.zeros(256, 256, **meta))
    with pytest.raises(ValueError, match="no checkpoint kernel"):
        tops.quantize_int8(torch.zeros(256, 256, **meta))
    with pytest.raises(ValueError, match="no checkpoint kernel"):
        tops.dequantize_int8(torch.zeros(256, 256, dtype=torch.int8, **meta),
                             torch.zeros(256, 1, **meta))
    with pytest.raises(ValueError, match="no checkpoint kernel"):
        tops.delta_f32(torch.zeros(4, **meta), torch.zeros(4, **meta))
    with pytest.raises(ValueError, match="no checkpoint kernel"):
        tops.fused_xor_fold(torch.zeros(4, dtype=torch.int32, **meta),
                            torch.zeros(4, dtype=torch.int32, **meta))
    # the reference's asserted shapes raise ValueError
    for shape in ((255, 256), (256, 200), (256,)):
        with pytest.raises(ValueError, match="downcast_bf16"):
            tops.downcast_bf16(torch.zeros(shape))
    for shape in ((256, 512), (100, 256)):
        with pytest.raises(ValueError, match="quantize_int8"):
            tops.quantize_int8(torch.zeros(shape))
    with pytest.raises(ValueError, match="quantize_int8"):
        tops.quantize_int8(torch.zeros(256, 256, dtype=torch.float64))
    with pytest.raises(ValueError, match="dequantize_int8"):
        tops.dequantize_int8(torch.zeros(256, 256, dtype=torch.int8),
                             torch.zeros(256))
    with pytest.raises(ValueError, match="dequantize_int8"):
        tops.dequantize_int8(torch.zeros(100, 256, dtype=torch.int8),
                             torch.zeros(100, 1))
    with pytest.raises(ValueError, match="float32"):
        tops.delta_f32(torch.zeros(4), torch.zeros(5))
    with pytest.raises(ValueError, match="int32"):
        tops.fused_xor_fold(torch.zeros(4, dtype=torch.int32),
                            torch.zeros(4, dtype=torch.int64))


def test_cuda_entry_points_refuse_host_tensors():
    """On a CUDA tensor a wrapper launches the kernel or raises; the
    kernels' entry points never run on a host tensor."""
    x = torch.zeros(256, 256)
    for call in (lambda: tq.downcast_bf16_cuda(x),
                 lambda: tq.quantize_int8_cuda(x),
                 lambda: tq.dequantize_int8_cuda(
                     torch.zeros(256, 256, dtype=torch.int8),
                     torch.zeros(256, 1))):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    with pytest.raises(ValueError, match="cuda"):
        delta.delta_f32_cuda(torch.zeros(4), torch.zeros(4))
    with pytest.raises(ValueError, match="cuda"):
        fused.xor_fold_checksum_cuda(torch.zeros(4, dtype=torch.int32),
                                     torch.zeros(4, dtype=torch.int32))


@pytest.mark.parametrize("n", [1, 3, 5, 4097, 65_536 + 1030])
def test_plain_flat_downcast_matches_reference(n):
    """The flat downcast (lengths no (R, C) of the shape contract gives:
    the kernel's partial tiles) rounds as the 2-D one and the oracle."""
    x = _downcast_input(256, 512, seed=n).reshape(-1)[:n].copy()
    got = tq.downcast_bf16_words_plain(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (n,)
    bits = got.view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(bits, _u16(jref.downcast_bf16_ref(x)))
    whole = _downcast_input(256, 512, seed=n)
    np.testing.assert_array_equal(
        bits, tq.downcast_bf16_plain(torch.from_numpy(whole)).reshape(-1)[:n]
        .view(torch.int16).numpy().view(np.uint16))


def test_flat_downcast_refuses_other_shapes_and_host_tensors():
    with pytest.raises(ValueError, match="flat float32"):
        tq.downcast_bf16_words_plain(torch.zeros(4, 4))
    with pytest.raises(ValueError, match="flat float32"):
        tq.downcast_bf16_words_plain(torch.zeros(4, dtype=torch.float64))
    with pytest.raises(ValueError, match="CUDA"):
        tq.downcast_bf16_words_cuda(torch.zeros(5))


def test_reduction_entry_points_are_in_the_library():
    src = "".join(s.read_text() for s in build.SOURCES)
    for kern in (tq.DOWNCAST_BF16_KERNEL, tq.QUANT_INT8_KERNEL,
                 tq.DEQUANT_INT8_KERNEL, delta.F32_KERNEL,
                 fused.FOLD_KERNEL):
        assert kern.symbol in build.SIGNATURES
        assert src.count(f'extern "C" int {kern.symbol}(') == 1


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    view = torch.int16 if a.element_size() == 2 else torch.int32
    return a.dtype == b.dtype and a.shape == b.shape \
        and torch.equal(a.view(view), b.view(view))


@pytest.mark.gpu
@pytest.mark.parametrize("n_rows", [256, 512, 4096])
def test_cuda_reduction_kernels_match_plain(n_rows):
    _cuda_or_skip()
    x = torch.from_numpy(_downcast_input(n_rows, 512, seed=n_rows)).cuda()
    assert _same_bits(tops.downcast_bf16(x), tq.downcast_bf16_plain(x))
    rows = torch.from_numpy(_rows(n_rows, seed=n_rows)).cuda()
    rows[1, 5] = float("nan")
    rows[2, [7, 9]] = torch.tensor([float("inf"), float("-inf")]).cuda()
    q, s = tops.quantize_int8(rows)
    pq, ps = tq.quantize_int8_plain(rows)
    assert torch.equal(q, pq) and _same_bits(s, ps)
    s = s.clone()
    k = DEQUANT_EDGE_SCALES.size
    s[:k, 0] = torch.from_numpy(DEQUANT_EDGE_SCALES).cuda()
    assert _same_bits(tops.dequantize_int8(q, s),
                      tq.dequantize_int8_plain(q, s))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [
    (1,), (3,), (4,), (5,), (delta.TILE_WORDS - 1,), (delta.TILE_WORDS + 1,),
    (10 * delta.TILE_WORDS + delta.TILE_WORDS // 4 + 3,),
    (256, 256), (256, 768), (768, 1280)])
def test_cuda_downcast_matches_plain_at_tile_edges(shape):
    """The streaming core's tile edges: flat lengths with a partial last
    tile and trailing words (through the flat entry) and (R, C) shapes,
    with the NaN, signalling-NaN, subnormal and tie values in front and
    at the end."""
    _cuda_or_skip()
    g = torch.Generator(device="cuda").manual_seed(sum(shape))
    x = torch.randn(shape, device="cuda", generator=g) * 100
    edge = torch.cat([tq.edge_values("cuda"),
                      torch.from_numpy(DOWNCAST_EDGES).cuda()])
    flat = x.view(-1)
    k = min(flat.numel(), edge.numel())
    flat[:k] = edge[:k]
    flat[flat.numel() - k:] = edge[:k]
    if len(shape) == 1:
        got, want = (tq.downcast_bf16_words_cuda(x),
                     tq.downcast_bf16_words_plain(x))
    else:
        got, want = tops.downcast_bf16(x), tq.downcast_bf16_plain(x)
    assert _same_bits(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 3, 65_537, 1 << 20])
def test_cuda_elementwise_kernels_match_plain(n):
    _cuda_or_skip()
    g = torch.Generator(device="cuda").manual_seed(n)
    a = torch.randn(n, device="cuda", generator=g)
    b = torch.randn(n, device="cuda", generator=g)
    for i, (u, v) in enumerate(DELTA_EDGES[:n]):
        a[i], b[i] = float(u), float(v)
    assert _same_bits(tops.delta_f32(a, b), delta.delta_f32_plain(a, b))
    wa, wb = a.view(torch.int32), b.view(torch.int32)
    f, dig = tops.fused_xor_fold(wa, wb)
    pf, pdig = fused.xor_fold_checksum_plain(wa, wb)
    assert torch.equal(f, pf) and dig == pdig
