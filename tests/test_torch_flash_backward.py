"""The blocked attention's backward (``repro_torch.models.layers._Flash``)
held against ``jax.grad`` of ``repro.models.layers.blocked_sdpa``, and
training past 2,048 tokens against the JAX package's trainer.

* ``_Flash`` (the kernel's forward with row stats, the plain version on
  the CPU, and the reference's blockwise backward) at S 2,100 with
  ``kv_block`` 1,024 (a ragged last block: the reference pads it, the
  port cuts it), 4/2 heads, ``full``, ``window`` 300 and ``chunked`` 512,
  hd 64 and 128: the output and dq, dk, dv against ``jax.vjp`` of
  ``blocked_sdpa`` under the same cotangent, fp32 within ``rtol=1e-5``
  and an ``atol`` of ``1e-6`` times the gradient's largest entry (the
  same algorithm: P recomputed from the row stats in fp32 both ways, but
  a gradient entry sums up to 2,100 unit-scale terms in another order, so
  its rounding follows the terms' scale, not its own), bf16 within ``2e-2``
  relative L2 error a gradient (the output is cast to bf16 before ``D =
  sum(dout * out)`` in the port, in fp32 in the reference, and bf16 inputs
  round at other points).
* The same at hd 256 (``full``, ``window`` 300) and with the prefix-LM's
  prefix (``n_prefix`` 256 or 300, ``full`` at hd 64 and 256, ``chunked``
  512 at hd 128): ``blocked_sdpa(n_prefix=...)`` both ways, the same
  tolerances.
* The row stats ``m`` and ``l`` of the plain version against the
  reference's ``_flash_fwd_impl``.
* Training through it past 2,048 tokens is held in
  ``tests/test_torch_zoo_training.py``.
* On a card (``gpu``-marked, skipped here): ``_Flash`` on CUDA tensors
  (the kernel's forward and stats) against autograd through the plain
  version.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import layers  # noqa: E402

S, KV_BLOCK, H, KV = 2100, 1024, 4, 2
KINDS = [("full", 0, 0), ("window", 300, 0), ("chunked", 0, 512)]


def _draw(shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _inputs(hd: int, seed: int):
    return (_draw((1, S, H, hd), seed), _draw((1, S, KV, hd), seed + 1),
            _draw((1, S, KV, hd), seed + 2), _draw((1, S, H * hd), seed + 3))


@pytest.mark.parametrize("kind,window,chunk", KINDS)
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_backward_matches_jax_grad(kind, window, chunk, hd, dtype):
    _check_backward(kind, window, chunk, hd, dtype, 0)


@pytest.mark.parametrize("hd,kind,window,chunk,n_prefix,dtype", [
    (256, "full", 0, 0, 0, "float32"), (256, "window", 300, 0, 0, "float32"),
    (256, "full", 0, 0, 0, "bfloat16"), (64, "full", 0, 0, 256, "float32"),
    (256, "full", 0, 0, 256, "float32"), (256, "full", 0, 0, 256, "bfloat16"),
    (128, "chunked", 0, 512, 300, "float32")])
def test_flash_backward_at_hd256_and_with_a_prefix_matches_jax_grad(
        hd, kind, window, chunk, n_prefix, dtype):
    _check_backward(kind, window, chunk, hd, dtype, n_prefix)


def _check_backward(kind, window, chunk, hd, dtype, n_prefix):
    qn, kn, vn, don = _inputs(hd, hd + len(kind) + n_prefix)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (qn, kn, vn))
    jout, vjp = jax.vjp(lambda q, k, v: JL.blocked_sdpa(
        q, k, v, kind=kind, window=window, chunk=chunk, n_prefix=n_prefix,
        kv_block=KV_BLOCK), jq, jk, jv)
    jgrads = vjp(jnp.asarray(don).astype(jdt))
    q, k, v = (torch.from_numpy(a).to(tdt).requires_grad_(True)
               for a in (qn, kn, vn))
    out = layers.blocked_sdpa(q, k, v, kind=kind, window=window,
                              chunk=chunk, n_prefix=n_prefix,
                              kv_block=KV_BLOCK)
    assert out.dtype == tdt and out.grad_fn is not None
    grads = torch.autograd.grad(out, (q, k, v),
                                torch.from_numpy(don).to(tdt))
    if dtype == "float32":
        np.testing.assert_allclose(_f32(out), _f32(jout), rtol=3e-5,
                                   atol=3e-5)
        for name, g, jg in zip("qkv", grads, jgrads):
            assert g.dtype == torch.float32
            want = _f32(jg)
            np.testing.assert_allclose(_f32(g), want, rtol=1e-5,
                                       atol=1e-6 * np.abs(want).max(),
                                       err_msg=f"d{name}")
    else:
        for name, g, jg in zip("qkv", grads, jgrads):
            assert g.dtype == torch.bfloat16
            err = np.linalg.norm(_f32(g) - _f32(jg)) \
                / np.linalg.norm(_f32(jg))
            assert err < 2e-2, (f"d{name}", err)


@pytest.mark.parametrize("kind,window,chunk", KINDS)
def test_row_stats_match_reference(kind, window, chunk):
    """``flash_attention_plain(return_stats=True)``'s m and l are
    ``_flash_fwd_impl``'s, (B, S, H) fp32 within ``rtol=1e-5, atol=1e-6``;
    the output is unchanged by asking for them."""
    B, S_, hd, kvb = 2, 300, 64, 128
    qn = _draw((B, S_, H, hd), 1)
    kn, vn = _draw((B, S_, KV, hd), 2), _draw((B, S_, KV, hd), 3)
    qg = jnp.asarray(qn).reshape(B, S_, KV, H // KV, hd) / math.sqrt(hd)
    pad = (-S_) % kvb
    kp, vp = (jnp.pad(jnp.asarray(a), ((0, 0), (0, pad), (0, 0), (0, 0)))
              for a in (kn, vn))
    qp = jnp.pad(qg, ((0, 0), (0, pad), (0, 0), (0, 0), (0, 0)))
    _o, (jm, jl) = JL._flash_fwd_impl(qp, kp, vp, kind, window, chunk, 0,
                                      kvb, False)
    q, k, v = (torch.from_numpy(a) for a in (qn, kn, vn))
    out, m, l = fa.flash_attention_plain(q, k, v, kind=kind, window=window,
                                         chunk=chunk, kv_block=kvb,
                                         return_stats=True)
    assert m.shape == l.shape == (B, S_, H) and m.dtype == torch.float32
    np.testing.assert_allclose(m.numpy(), np.asarray(jm)[:, :S_].reshape(
        B, S_, H), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(l.numpy(), np.asarray(jl)[:, :S_].reshape(
        B, S_, H), rtol=1e-5, atol=1e-6)
    assert torch.equal(out, fa.flash_attention_plain(
        q, k, v, kind=kind, window=window, chunk=chunk, kv_block=kvb))


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_backward_matches_plain_autograd(hd, dtype):
    """On a card: the output and dq, dk, dv of ``_Flash`` (the kernel's
    forward and row stats) against autograd through the plain version,
    within 2e-5 (fp32) and 2e-2 (bf16) as the forward is held; with a
    prefix of 256 too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tdt = getattr(torch, dtype)
    tol = {"float32": 2e-5, "bfloat16": 2e-2}[dtype]
    for (kind, window, chunk), n_prefix in [(m, 0) for m in KINDS] \
            + [(KINDS[0], 256)]:
        qn, kn, vn, don = _inputs(hd, 7)
        ins = [torch.from_numpy(a).cuda().to(tdt) for a in (qn, kn, vn)]
        dout = torch.from_numpy(don).cuda().to(tdt)
        q, k, v = (t.clone().requires_grad_(True) for t in ins)
        key = (hd, kind, bool(n_prefix), True)
        before = fa.LAUNCHES_BY[key]
        out = layers.blocked_sdpa(q, k, v, kind=kind, window=window,
                                  chunk=chunk, n_prefix=n_prefix,
                                  kv_block=KV_BLOCK)
        grads = torch.autograd.grad(out, (q, k, v), dout)
        assert fa.LAUNCHES_BY[key] == before + 1
        pq, pk, pv = (t.clone().requires_grad_(True) for t in ins)
        want = fa.flash_attention_plain(pq, pk, pv, kind=kind,
                                        window=window, chunk=chunk,
                                        n_prefix=n_prefix,
                                        kv_block=KV_BLOCK)
        wgrads = torch.autograd.grad(want, (pq, pk, pv), dout)
        torch.cuda.synchronize()
        np.testing.assert_allclose(_f32(out.cpu()), _f32(want.cpu()),
                                   rtol=tol, atol=tol)
        for name, g, w in zip("qkv", grads, wgrads):
            err = float((g.float() - w.float()).norm()
                        / w.float().norm())
            assert err < max(tol, 1e-4), (kind, f"d{name}", err)
