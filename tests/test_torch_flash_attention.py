"""The port's flash attention held against the JAX package.

The same numpy inputs (bf16 cases round the same fp32 draws to bf16 in
both packages, which gives the same bits) go through:

* ``repro.kernels.ops.flash_attention`` — the Pallas TPU kernel, run in
  interpret mode as ``tests/test_kernels.py`` runs it — at that test's
  shapes (B 2, S 512, 4/2 heads, hd 64; ``full``, ``window`` 128,
  ``chunked`` 128) against the port's plain version: within 2e-5 in fp32
  and 2e-2 in bf16, the tolerances of ``tests/test_kernels.py:120``. Both
  accumulate in fp32; they differ in summation order and, in bf16, by one
  rounding of the output.
* ``repro.models.layers.blocked_sdpa`` at S 2,100 (padded to 3,072 keys
  by 1,024-key blocks) against the port's ``blocked_sdpa``: within 3e-5 in
  fp32, the tolerance of ``tests/test_kernels.py:156`` for the same pair
  of algorithms, and 2e-2 in bf16.
* ``repro.kernels.ref.flash_attention_ref`` (plain masked softmax) at odd
  sizes, ragged against the KV block and with fewer keys than queries:
  within 2e-5 in fp32.
* Both, at the CUDA kernel's 128-row tile boundaries (S 127, 128, 129, and
  300 queries over 200 keys) with a window narrower than a tile (32) and
  chunks that straddle tiles (192): the Pallas kernel in interpret mode in
  fp32 and bf16, the masked softmax in fp32 on every row that sees a key
  (it gives a row that sees none the mean of v, the flash kernels 0).

At hd 256 (recurrentgemma-2b's and paligemma-3b's width) the plain
version is held against the Pallas kernel in interpret mode and the
masked softmax under every mask, at ragged S and with GQA, within the same
tolerances. With a prefix (``n_prefix``: the first positions also see
each other, the prefix-LM's mask) it is held against
``repro.models.layers.blocked_sdpa(n_prefix=...)`` past the direct path
(3e-5 fp32, 2e-2 bf16) and against a masked softmax under
``repro.models.layers.make_mask(n_prefix=...)`` (2e-5).

The wrapper raises under grad (``layers._Flash`` is the way to train
through it; the model's blocked path under grad is held in
``tests/test_torch_model.py`` and ``tests/test_torch_flash_backward.py``),
never falls back on a CUDA tensor, and counts only its own launches. A ``gpu``-marked
test holds the CUDA kernel against the plain version on a card at the same
tile edges and masks, in both dtypes; it skips inside the test on a host
without one. The kernel's source is checked here for what its bf16 body is
built from: TMA loads under ``mbarrier``s, ``wgmma`` for both products, a
producer warpgroup beside the consumers, and no ``mma.sync``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as jlayers
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import variants
from repro_torch.models import layers

KINDS = [("full", 0, 0), ("window", 128, 0), ("chunked", 0, 128)]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _draw(shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _both(arrs, dtype: str):
    """(jax arrays, torch tensors) of the fp32 numpy ``arrs`` in ``dtype``."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return ([jnp.asarray(a).astype(jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _qkv(B, S, T, H, KV, hd, seed):
    return (_draw((B, S, H, hd), seed), _draw((B, T, KV, hd), seed + 1),
            _draw((B, T, KV, hd), seed + 2))


@pytest.mark.parametrize("kind,window,chunk", KINDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_kernel(kind, window, chunk, dtype):
    B, S, H, KV, hd = 2, 512, 4, 2, 64
    (jq, jk, jv), (q, k, v) = _both(_qkv(B, S, S, H, KV, hd, 0), dtype)
    want = jops.flash_attention(jq, jk, jv, kind=kind, window=window,
                                chunk=chunk, q_block=128, kv_block=128,
                                interpret=True)
    got = tops.flash_attention(q, k, v, kind=kind, window=window,
                               chunk=chunk, kv_block=128)
    assert got.shape == (B, S, H * hd) and got.dtype == q.dtype
    np.testing.assert_allclose(_f32(got), _f32(want).reshape(B, S, H * hd),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype,tol", [("float32", 3e-5),
                                       ("bfloat16", 2e-2)])
def test_blocked_sdpa_matches_reference_past_the_direct_path(dtype, tol):
    B, S, H, KV, hd = 1, 2100, 4, 2, 64
    assert S > layers.DIRECT_SDPA_MAX_SEQ and S % 1024
    (jq, jk, jv), (q, k, v) = _both(_qkv(B, S, S, H, KV, hd, 3), dtype)
    want = jlayers.blocked_sdpa(jq, jk, jv, kv_block=1024)
    got = layers.blocked_sdpa(q, k, v, kv_block=1024)
    assert got.dtype == q.dtype
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)
    # the model's dispatch takes the same path past 2,048 tokens
    assert torch.equal(layers.full_seq_sdpa(q, k, v), got)


@pytest.mark.parametrize("S,T", [(1, 1), (37, 37), (257, 257), (70, 50)])
@pytest.mark.parametrize("kind,window,chunk", [("full", 0, 0),
                                               ("window", 40, 0),
                                               ("chunked", 0, 48)])
def test_plain_matches_masked_softmax_at_odd_sizes(S, T, kind, window,
                                                   chunk):
    B, H, KV, hd = 2, 4, 1, 32
    qn, kn, vn = _qkv(B, S, T, H, KV, hd, S + T)
    got = fa.flash_attention_plain(
        torch.from_numpy(qn), torch.from_numpy(kn), torch.from_numpy(vn),
        kind=kind, window=window, chunk=chunk, kv_block=64)
    fold = lambda a, n: np.repeat(a, H // a.shape[2], 2).transpose(
        0, 2, 1, 3).reshape(B * H, n, hd)
    want = np.asarray(jref.flash_attention_ref(
        fold(qn, S), fold(kn, T), fold(vn, T), kind=kind, window=window,
        chunk=chunk)).reshape(B, H, S, hd).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(got.numpy(), want.reshape(B, S, H * hd),
                               atol=2e-5, rtol=2e-5)


#: the CUDA kernel's tile edges: one row short of, on and past a 128-row
#: tile, and fewer keys than queries
TILE_EDGES = [(127, 127), (128, 128), (129, 129), (300, 200)]
TILE_KINDS = [("full", 0, 0), ("window", 32, 0), ("chunked", 0, 192)]


def _pallas_block(n: int) -> int:
    """A block that divides ``n`` (the Pallas kernel asserts it)."""
    return 64 if n % 64 == 0 else n


@pytest.mark.parametrize("S,T", TILE_EDGES)
@pytest.mark.parametrize("kind,window,chunk", TILE_KINDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_kernel_at_tile_edges(S, T, kind, window, chunk,
                                                   dtype):
    B, H, KV, hd = 1, 4, 2, 64
    (jq, jk, jv), (q, k, v) = _both(_qkv(B, S, T, H, KV, hd, 11 + S), dtype)
    want = jops.flash_attention(jq, jk, jv, kind=kind, window=window,
                                chunk=chunk, q_block=_pallas_block(S),
                                kv_block=_pallas_block(T), interpret=True)
    got = tops.flash_attention(q, k, v, kind=kind, window=window,
                               chunk=chunk, kv_block=128)
    assert got.shape == (B, S, H * hd) and got.dtype == q.dtype
    np.testing.assert_allclose(_f32(got), _f32(want).reshape(B, S, H * hd),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("S,T", TILE_EDGES)
@pytest.mark.parametrize("kind,window,chunk", TILE_KINDS)
def test_plain_matches_masked_softmax_at_tile_edges(S, T, kind, window,
                                                    chunk):
    B, H, KV, hd = 1, 4, 2, 64
    qn, kn, vn = _qkv(B, S, T, H, KV, hd, 23 + T)
    got = fa.flash_attention_plain(
        torch.from_numpy(qn), torch.from_numpy(kn), torch.from_numpy(vn),
        kind=kind, window=window, chunk=chunk, kv_block=128).numpy()
    fold = lambda a, n: np.repeat(a, H // a.shape[2], 2).transpose(
        0, 2, 1, 3).reshape(B * H, n, hd)
    want = np.asarray(jref.flash_attention_ref(
        fold(qn, S), fold(kn, T), fold(vn, T), kind=kind, window=window,
        chunk=chunk)).reshape(B, H, S, hd).transpose(0, 2, 1, 3)
    sees = fa.allowed(torch.arange(S), torch.arange(T), kind, window,
                      chunk).any(1).numpy()
    assert sees.any()
    got = got.reshape(B, S, H * hd)
    np.testing.assert_allclose(got[:, sees],
                               want.reshape(B, S, H * hd)[:, sees],
                               atol=2e-5, rtol=2e-5)
    # a row that sees no key is 0 / (0 + 1e-30) in the flash kernels
    assert not got[:, ~sees].any()


def test_fully_masked_rows_are_zero():
    """A window of 0 masks every key: each row's output is
    ``0 / (0 + 1e-30) = 0``, not a mean of v (``exp(0)`` must not leak
    into ``l`` from the masked logits)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 20, 20, 2, 2, 16, 5))
    out = fa.flash_attention_plain(q, k, v, kind="window", window=0,
                                   kv_block=8)
    assert torch.equal(out, torch.zeros_like(out))


def test_refuses_grad_and_bad_inputs():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 8, 4, 2, 64, 6))
    with pytest.raises(NotImplementedError, match="backward"):
        tops.flash_attention(q.requires_grad_(True), k, v)
    with pytest.raises(NotImplementedError, match="_Flash"):
        tops.flash_attention(q, k, v, return_stats=True)
    with torch.no_grad():
        assert tops.flash_attention(q, k, v).shape == (1, 8, 256)
    q = q.detach()
    with pytest.raises(ValueError, match="chunk"):
        tops.flash_attention(q, k, v, kind="chunked")
    with pytest.raises(ValueError, match="kind"):
        tops.flash_attention(q, k, v, kind="prefix")
    with pytest.raises(ValueError, match="multiple of KV"):
        tops.flash_attention(q[:, :, :3], k, v)
    with pytest.raises(ValueError, match="dtype"):
        tops.flash_attention(q.double(), k.double(), v.double())


def test_cuda_wrapper_never_takes_cpu_tensors():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 8, 2, 2, 64, 7))
    before = fa.KERNEL.launches
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_cuda(q, k, v)
    tops.flash_attention(q, k, v)
    assert fa.KERNEL.launches == before


def test_entry_point_is_in_the_library():
    assert fa.KERNEL.symbol in build.SIGNATURES
    src = (build.CSRC / "flash_attention.cu").read_text()
    assert build.CSRC / "flash_attention.cu" in build.SOURCES
    assert f'extern "C" int {fa.KERNEL.symbol}(' in src
    # q, k, v, out, the row stats m and l (null when not asked for),
    # eleven sizes and flags (n_prefix last), the stream
    assert len(build.SIGNATURES[fa.KERNEL.symbol]) == 18


def test_bf16_body_is_a_warp_specialised_tma_wgmma_pipeline():
    src = (build.CSRC / "flash_attention.cu").read_text()
    code = "\n".join(line.split("//")[0] for line in src.splitlines())
    for part in ("cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier",
                 "mbarrier.try_wait.parity", "wgmma.mma_async.sync.aligned."
                 "m64n128k16.f32.bf16.bf16", "wgmma.mma_async.sync.aligned."
                 "m64n64k16.f32.bf16.bf16", "setmaxnreg.dec",
                 "setmaxnreg.inc", "CU_TENSOR_MAP_SWIZZLE_128B",
                 "cp.async.bulk.tensor.4d.global.shared::cta"):
        assert part in code, part
    assert "mma.sync" not in code


@pytest.mark.parametrize("name", sorted(variants.ABLATIONS))
def test_ablations_apply_to_the_kernel_source(name):
    """Each ablation of ``python -m repro_torch.kernels.variants`` edits
    the shipped source (so the tool does not silently time the kernel
    unchanged); only the shipped kernel is left as it is."""
    src = (build.CSRC / "flash_attention.cu").read_text()
    out = variants.variant_source(variants.ABLATIONS[name])
    assert (out == src) == (name == "kernel")
    with pytest.raises(ValueError, match="not in"):
        variants.variant_source([["no such text", ""]])


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("S,T", [(1, 1), (127, 127), (128, 128), (129, 129),
                                 (257, 257), (300, 200), (2100, 2100)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads", [(32, 8), (4, 4)])
def test_cuda_kernel_matches_plain(S, T, dtype, heads):
    _cuda_or_skip()
    H, KV = heads
    (_j, cpu) = _both(_qkv(1, S, T, H, KV, 64, S), dtype)
    q, k, v = (t.cuda() for t in cpu)
    kinds = [("full", 0, 0), ("window", 300, 0), ("window", 32, 0),
             ("chunked", 0, 512), ("chunked", 0, 192)]
    before = fa.KERNEL.launches
    for kind, window, chunk in kinds:
        got = tops.flash_attention(q, k, v, kind=kind, window=window,
                                   chunk=chunk)
        want = fa.flash_attention_plain(q, k, v, kind=kind, window=window,
                                        chunk=chunk)
        torch.cuda.synchronize()
        np.testing.assert_allclose(_f32(got.cpu()), _f32(want.cpu()),
                                   atol=TOL[dtype], rtol=TOL[dtype])
    assert fa.KERNEL.launches == before + len(kinds)


def test_kernel_takes_hd_64_and_128_with_row_stats():
    """Both bodies are instantiated at hd 64, 128 and 256, and the one
    entry point takes the row stats' buffers after the output (null when
    they are not asked for) and the prefix after the chunk; no second
    entry point."""
    assert fa.KERNEL_HEAD_DIM == {64, 128, 256}
    src = (build.CSRC / "flash_attention.cu").read_text()
    for part in ("launch_bf16<64>", "launch_bf16<128>", "launch_bf16<256>",
                 "launch_f32<64>", "launch_f32<128>", "launch_f32<256>",
                 f'extern "C" int {fa.KERNEL.symbol}(',
                 "void* out, void* m, void* l,",
                 "int64_t n_prefix, void* stream)"):
        assert part in src, part
    assert src.count('extern "C"') == 1
    assert len(build.SIGNATURES[fa.KERNEL.symbol]) == 18
    q = torch.zeros(1, 4, 2, 96)
    with torch.no_grad():   # the plain version takes any width
        assert tops.flash_attention(q, q, q).shape == (1, 4, 192)


@pytest.mark.gpu
@pytest.mark.parametrize("S,T", [(1, 1), (127, 127), (128, 128), (129, 129),
                                 (257, 257), (300, 200), (2100, 2100)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads", [(32, 16), (4, 4)])
def test_cuda_kernel_matches_plain_at_hd128(S, T, dtype, heads):
    """The hd-128 instantiation (two consumer warpgroups, 64-column
    halves) at the tile edges of its 128-row CTAs and every mask."""
    _cuda_or_skip()
    H, KV = heads
    (_j, cpu) = _both(_qkv(1, S, T, H, KV, 128, S + 1), dtype)
    q, k, v = (t.cuda() for t in cpu)
    kinds = [("full", 0, 0), ("window", 300, 0), ("window", 32, 0),
             ("chunked", 0, 512), ("chunked", 0, 192)]
    before = fa.KERNEL.launches
    for kind, window, chunk in kinds:
        got = tops.flash_attention(q, k, v, kind=kind, window=window,
                                   chunk=chunk)
        want = fa.flash_attention_plain(q, k, v, kind=kind, window=window,
                                        chunk=chunk)
        torch.cuda.synchronize()
        np.testing.assert_allclose(_f32(got.cpu()), _f32(want.cpu()),
                                   atol=TOL[dtype], rtol=TOL[dtype])
    assert fa.KERNEL.launches == before + len(kinds)


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_row_stats_match_plain(hd, dtype):
    """The kernel's m and l against the plain version's: within 1e-3
    absolute plus 1e-4 (m) and 1e-3 (l) relative (m comes back from log2
    units in the bf16 body, and its products are bf16 inputs summed in
    fp32 in another order); the output equals the call without stats."""
    _cuda_or_skip()
    (_j, cpu) = _both(_qkv(2, 300, 300, 4, 2, hd, hd), dtype)
    q, k, v = (t.cuda() for t in cpu)
    for kind, window, chunk in KINDS + [("window", 0, 0)]:
        out, m, l = tops.flash_attention(q, k, v, kind=kind, window=window,
                                         chunk=chunk, return_stats=True)
        _o, wm, wl = fa.flash_attention_plain(
            q, k, v, kind=kind, window=window, chunk=chunk,
            return_stats=True)
        torch.cuda.synchronize()
        assert torch.equal(out, tops.flash_attention(
            q, k, v, kind=kind, window=window, chunk=chunk))
        np.testing.assert_allclose(m.cpu().numpy(), wm.cpu().numpy(),
                                   atol=1e-3, rtol=1e-4)
        np.testing.assert_allclose(l.cpu().numpy(), wl.cpu().numpy(),
                                   atol=1e-3, rtol=1e-3)


# ---------------------------------------------------- hd 256 and the prefix
HD256_CASES = [(256, 256, 4, 2), (300, 200, 4, 1), (129, 129, 2, 2)]


@pytest.mark.parametrize("S,T,H,KV", HD256_CASES)
@pytest.mark.parametrize("kind,window,chunk", TILE_KINDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_kernel_at_hd256(S, T, H, KV, kind, window,
                                              chunk, dtype):
    """hd 256 (four 64-column parts a row in the CUDA kernel, 64-key
    tiles): the plain version against the Pallas kernel in interpret
    mode, ragged S, fewer keys than queries, GQA, every mask."""
    B, hd = 1, 256
    (jq, jk, jv), (q, k, v) = _both(_qkv(B, S, T, H, KV, hd, 31 + S),
                                    dtype)
    want = jops.flash_attention(jq, jk, jv, kind=kind, window=window,
                                chunk=chunk, q_block=_pallas_block(S),
                                kv_block=_pallas_block(T), interpret=True)
    got = tops.flash_attention(q, k, v, kind=kind, window=window,
                               chunk=chunk, kv_block=64)
    assert got.shape == (B, S, H * hd) and got.dtype == q.dtype
    np.testing.assert_allclose(_f32(got), _f32(want).reshape(B, S, H * hd),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("S,T,H,KV", HD256_CASES)
@pytest.mark.parametrize("kind,window,chunk", TILE_KINDS)
def test_plain_matches_masked_softmax_at_hd256(S, T, H, KV, kind, window,
                                               chunk):
    B, hd = 2, 256
    qn, kn, vn = _qkv(B, S, T, H, KV, hd, 41 + T)
    got = fa.flash_attention_plain(
        torch.from_numpy(qn), torch.from_numpy(kn), torch.from_numpy(vn),
        kind=kind, window=window, chunk=chunk, kv_block=64).numpy()
    fold = lambda a, n: np.repeat(a, H // a.shape[2], 2).transpose(
        0, 2, 1, 3).reshape(B * H, n, hd)
    want = np.asarray(jref.flash_attention_ref(
        fold(qn, S), fold(kn, T), fold(vn, T), kind=kind, window=window,
        chunk=chunk)).reshape(B, H, S, hd).transpose(0, 2, 1, 3)
    sees = fa.allowed(torch.arange(S), torch.arange(T), kind, window,
                      chunk).any(1).numpy()
    got = got.reshape(B, S, H * hd)
    np.testing.assert_allclose(got[:, sees],
                               want.reshape(B, S, H * hd)[:, sees],
                               atol=2e-5, rtol=2e-5)
    assert not got[:, ~sees].any()


#: (hd, kind, window, chunk, n_prefix) with a prefix: the prefix-LM's own
#: (paligemma: full, hd 256), and the prefix with the other masks
PREFIX_CASES = [(256, "full", 0, 0, 256), (64, "window", 200, 0, 256),
                (128, "chunked", 0, 192, 300), (64, "full", 0, 0, 2100)]


@pytest.mark.parametrize("hd,kind,window,chunk,n_prefix", PREFIX_CASES)
@pytest.mark.parametrize("dtype,tol", [("float32", 3e-5),
                                       ("bfloat16", 2e-2)])
def test_prefix_matches_reference_blocked_sdpa(hd, kind, window, chunk,
                                               n_prefix, dtype, tol):
    """``n_prefix`` through the port's blocked path (the plain version on
    the CPU) against the reference's ``blocked_sdpa(n_prefix=...)`` at S
    2,100 (padded to 3,072 by 1,024-key blocks there), 2/1 heads."""
    B, S, H, KV = 1, 2100, 2, 1
    (jq, jk, jv), (q, k, v) = _both(_qkv(B, S, S, H, KV, hd, 50 + hd),
                                    dtype)
    want = jlayers.blocked_sdpa(jq, jk, jv, kind=kind, window=window,
                                chunk=chunk, n_prefix=n_prefix,
                                kv_block=1024)
    got = layers.full_seq_sdpa(q, k, v, kind=kind, window=window,
                               chunk=chunk, n_prefix=n_prefix,
                               kv_block=1024)
    assert got.dtype == q.dtype
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("S,T", [(37, 37), (300, 200), (129, 129)])
@pytest.mark.parametrize("n_prefix", [1, 20, 128, 250])
@pytest.mark.parametrize("kind,window,chunk", TILE_KINDS)
def test_prefix_matches_masked_softmax(S, T, n_prefix, kind, window, chunk):
    """The plain version with a prefix against a direct masked softmax
    under the reference's ``make_mask(n_prefix=...)`` (keys past T cut
    off); rows that see no key are 0."""
    B, H, KV, hd = 1, 4, 2, 32
    qn, kn, vn = _qkv(B, S, T, H, KV, hd, 60 + n_prefix)
    got = fa.flash_attention_plain(
        torch.from_numpy(qn), torch.from_numpy(kn), torch.from_numpy(vn),
        kind=kind, window=window, chunk=chunk, n_prefix=n_prefix,
        kv_block=64).numpy().reshape(B, S, H, hd)
    n = max(S, T)
    mask = np.asarray(jlayers.make_mask(n, kind, window=window, chunk=chunk,
                                        n_prefix=n_prefix))[:S, :T]
    assert np.array_equal(mask, fa.allowed(
        torch.arange(S), torch.arange(T), kind, window, chunk,
        n_prefix).numpy())
    rep = H // KV
    k_, v_ = np.repeat(kn, rep, 2), np.repeat(vn, rep, 2)
    logits = np.einsum("bshd,bthd->bhst", qn, k_) / np.sqrt(hd)
    logits = np.where(mask, logits, -np.inf)
    sees = mask.any(1)
    p = np.exp(logits - logits.max(-1, keepdims=True, initial=-1e30))
    p = np.where(mask, p, 0.0)
    p = p / np.maximum(p.sum(-1, keepdims=True), 1e-30)
    want = np.einsum("bhst,bthd->bshd", p, v_)
    np.testing.assert_allclose(got[:, sees], want[:, sees], atol=2e-5,
                               rtol=2e-5)
    assert not got[:, ~sees].any()


def test_prefix_is_refused_below_zero_and_may_cover_every_position():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 8, 2, 2, 64, 9))
    with pytest.raises(ValueError, match="n_prefix"):
        tops.flash_attention(q, k, v, n_prefix=-1)
    # a prefix that covers every position is a full bidirectional mask
    full = fa.flash_attention_plain(q, k, v, n_prefix=8)
    want = torch.softmax(torch.einsum("bshd,bthd->bhst", q, k) / 8.0, -1)
    np.testing.assert_allclose(
        full.numpy(), torch.einsum("bhst,bthd->bshd", want, v).reshape(
            1, 8, 128).numpy(), atol=2e-5, rtol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("S,T", [(1, 1), (127, 127), (128, 128), (129, 129),
                                 (257, 257), (300, 200), (2100, 2100)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads", [(10, 1), (4, 4)])
def test_cuda_kernel_matches_plain_at_hd256(S, T, dtype, heads):
    """The hd-256 instantiation (two consumer warpgroups, four 64-column
    parts a row, 64-key tiles) at the tile edges and every mask, and with
    a prefix of 256 under ``full`` and ``window``."""
    _cuda_or_skip()
    H, KV = heads
    (_j, cpu) = _both(_qkv(1, S, T, H, KV, 256, S + 2), dtype)
    q, k, v = (t.cuda() for t in cpu)
    kinds = [("full", 0, 0, 0), ("window", 300, 0, 0), ("window", 32, 0, 0),
             ("chunked", 0, 512, 0), ("chunked", 0, 192, 0),
             ("full", 0, 0, 256), ("window", 200, 0, 256)]
    before = fa.KERNEL.launches
    for kind, window, chunk, n_prefix in kinds:
        got = tops.flash_attention(q, k, v, kind=kind, window=window,
                                   chunk=chunk, n_prefix=n_prefix)
        want = fa.flash_attention_plain(q, k, v, kind=kind, window=window,
                                        chunk=chunk, n_prefix=n_prefix)
        torch.cuda.synchronize()
        np.testing.assert_allclose(_f32(got.cpu()), _f32(want.cpu()),
                                   atol=TOL[dtype], rtol=TOL[dtype])
    assert fa.KERNEL.launches == before + len(kinds)


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,T", [(300, 300), (2100, 2100), (300, 200)])
def test_cuda_kernel_with_a_prefix_matches_plain(hd, dtype, S, T):
    """A prefix of 256 (and one past every position) at each head width,
    with every mask; counted under its launch key."""
    _cuda_or_skip()
    (_j, cpu) = _both(_qkv(1, S, T, 4, 2, hd, S + hd), dtype)
    q, k, v = (t.cuda() for t in cpu)
    for kind, window, chunk in TILE_KINDS:
        for n_prefix in (256, S + 1):
            before = fa.LAUNCHES_BY[(hd, kind, True, False)]
            got = tops.flash_attention(q, k, v, kind=kind, window=window,
                                       chunk=chunk, n_prefix=n_prefix)
            want = fa.flash_attention_plain(q, k, v, kind=kind,
                                            window=window, chunk=chunk,
                                            n_prefix=n_prefix)
            torch.cuda.synchronize()
            assert fa.LAUNCHES_BY[(hd, kind, True, False)] == before + 1
            np.testing.assert_allclose(_f32(got.cpu()), _f32(want.cpu()),
                                       atol=TOL[dtype], rtol=TOL[dtype])
