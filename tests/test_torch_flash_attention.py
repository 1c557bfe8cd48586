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

The wrapper raises under grad (the backward is not ported), never falls
back on a CUDA tensor, and counts only its own launches. A ``gpu``-marked
test holds the CUDA kernel against the plain version on a card; it skips
inside the test on a host without one.
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
    long = torch.zeros(1, layers.DIRECT_SDPA_MAX_SEQ + 1, 2, 64,
                       requires_grad=True)
    with pytest.raises(NotImplementedError, match="backward"):
        layers.full_seq_sdpa(long, long, long)
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
    assert len(build.SIGNATURES[fa.KERNEL.symbol]) == 15


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 257, 2100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads", [(32, 8), (4, 4)])
def test_cuda_kernel_matches_plain(S, dtype, heads):
    _cuda_or_skip()
    H, KV = heads
    (_j, cpu) = _both(_qkv(1, S, S, H, KV, 64, S), dtype)
    q, k, v = (t.cuda() for t in cpu)
    before = fa.KERNEL.launches
    for kind, window, chunk in [("full", 0, 0), ("window", 300, 0),
                                ("chunked", 0, 512)]:
        got = tops.flash_attention(q, k, v, kind=kind, window=window,
                                   chunk=chunk)
        want = fa.flash_attention_plain(q, k, v, kind=kind, window=window,
                                        chunk=chunk)
        torch.cuda.synchronize()
        np.testing.assert_allclose(_f32(got.cpu()), _f32(want.cpu()),
                                   atol=TOL[dtype], rtol=TOL[dtype])
    assert fa.KERNEL.launches == before + 3
