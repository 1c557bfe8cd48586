"""The port's dense llama forward, loss and backward held against the JAX
package.

The same JAX-initialised parameters (``repro.models.model.init_params``,
carried over by ``repro_torch.convert``) and the same batch (both
packages' ``SyntheticTokenPipeline`` draw it from one numpy seed) go
through ``repro.models.model.loss_fn`` under ``jax.value_and_grad`` and
through the port's ``loss_fn`` under ``torch.autograd.grad``, at
``smoke_variant(llama3.2-1b)``.

Tolerances, and why:

* float32: loss and every gradient leaf within ``rtol=1e-5, atol=1e-6``
  elementwise. Same algorithm, same cast points; XLA and ATen sum the
  matrix products and reductions in different orders.
* bfloat16: loss within ``2e-2`` relative, and each gradient leaf within
  ``2e-2`` relative error in its L2 norm. The bf16 matrix products and
  elementwise ops of the forward and backward round at other points in
  XLA and in ATen on the CPU; each rounding is ``2^-8`` relative, and
  measured leaves sit near 1.5e-2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.data.pipeline import SyntheticTokenPipeline as JPipeline
from repro.models import model as JM
from repro_torch.configs import get_config, smoke_variant
from repro_torch.convert import from_numpy_state
from repro_torch.core.tree import flatten_with_path, path_str
from repro_torch.data.pipeline import SyntheticTokenPipeline
from repro_torch.models import layers
from repro_torch.models import model as TM

BATCH, SEQ = 2, 32


def _configs(dtype: str):
    jcfg = dataclasses.replace(jsmoke(jget_config("llama3.2-1b")),
                               dtype=dtype)
    cfg = smoke_variant(get_config("llama3.2-1b", dtype=dtype))
    return jcfg, cfg


def _both(dtype: str, seed: int = 0):
    """(JAX loss, JAX grad leaves, port loss, port grads with paths)."""
    jcfg, cfg = _configs(dtype)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    flat, unflatten = flatten_with_path(from_numpy_state(tree, "cpu"))
    params = unflatten([t.requires_grad_(True) for _p, t in flat])
    jbatch = JPipeline(jcfg, BATCH, SEQ, seed=seed + 5).next_batch()
    batch = SyntheticTokenPipeline(cfg, BATCH, SEQ, seed=seed + 5) \
        .next_batch()
    np.testing.assert_array_equal(jbatch["tokens"], batch["tokens"])
    jloss, jgrads = jax.value_and_grad(lambda p: JM.loss_fn(
        jcfg, p, {"tokens": jnp.asarray(jbatch["tokens"])}))(jparams)
    loss = TM.loss_fn(cfg, params, {"tokens": torch.from_numpy(
        batch["tokens"])})
    grads = torch.autograd.grad(loss, [t for _p, t in flat])
    return (float(jloss), jax.tree_util.tree_leaves(jgrads),
            float(loss.detach()), [(path_str(p), g)
                                   for (p, _t), g in zip(flat, grads)])


def _f32(a) -> np.ndarray:
    return np.asarray(a).astype(np.float32)


def test_float32_loss_and_grads_match_reference():
    jloss, jgrads, loss, grads = _both("float32")
    assert loss == pytest.approx(jloss, rel=1e-5, abs=1e-6)
    assert len(grads) == len(jgrads)
    for (path, g), jg in zip(grads, jgrads):
        assert g.dtype == torch.float32, path
        np.testing.assert_allclose(g.numpy(), _f32(jg), rtol=1e-5,
                                   atol=1e-6, err_msg=path)


def test_bfloat16_loss_and_grads_match_reference():
    jloss, jgrads, loss, grads = _both("bfloat16", seed=1)
    assert loss == pytest.approx(jloss, rel=2e-2)
    for (path, g), jg in zip(grads, jgrads):
        want = _f32(jg)
        assert g.dtype == (torch.float32 if path.endswith("scale")
                           else torch.bfloat16), path
        err = np.linalg.norm(g.float().numpy() - want) \
            / np.linalg.norm(want)
        assert err < 2e-2, (path, err)


def test_adamw_step_on_the_gradient_tree_matches_reference():
    """The port's in-place AdamW on the gradient tree its backward gives
    (bf16 matrices, fp32 norm scales), against ``repro``'s AdamW on the
    same gradients: fp32 state within ``rtol=1e-6, atol=1e-7`` as in
    ``tests/test_torch_optim.py``, bf16 params wherever the masters agree
    bit for bit."""
    from repro.optim import adamw as jadamw
    from repro_torch.convert import to_numpy_state
    from repro_torch.optim import adamw
    jcfg, cfg = _configs("bfloat16")
    jparams = jax.tree_util.tree_map(
        np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(2)))
    flat, unflatten = flatten_with_path(from_numpy_state(jparams, "cpu"))
    params = unflatten([t.requires_grad_(True) for _p, t in flat])
    batch = SyntheticTokenPipeline(cfg, BATCH, SEQ, seed=2).next_batch_on(
        "cpu")
    grads = unflatten(list(torch.autograd.grad(
        TM.loss_fn(cfg, params, batch), [t for _p, t in flat])))
    np_grads = to_numpy_state(grads)
    opt = adamw.init_opt_state(params)
    adamw.apply_updates(params, opt, grads, adamw.AdamWConfig())
    jnew, jopt = jadamw.apply_updates(
        jparams, jadamw.init_opt_state(jparams),
        jax.tree_util.tree_map(
            lambda g: jnp.asarray(g.view(jnp.bfloat16))
            if g.dtype == np.uint16 else jnp.asarray(g), np_grads),
        jadamw.AdamWConfig())
    got = to_numpy_state(opt)
    for key in ("master", "m", "v"):
        for a, b in zip(jax.tree_util.tree_leaves(got[key]),
                        jax.tree_util.tree_leaves(jopt[key])):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6,
                                       atol=1e-7, err_msg=key)
    for p, w, jp, jw in zip(jax.tree_util.tree_leaves(to_numpy_state(params)),
                            jax.tree_util.tree_leaves(got["master"]),
                            jax.tree_util.tree_leaves(jnew),
                            jax.tree_util.tree_leaves(jopt["master"])):
        same = w == np.asarray(jw)
        jp = np.asarray(jp)
        if jp.dtype != np.float32:
            jp = jp.view(np.uint16)
        np.testing.assert_array_equal(p[same], jp[same])


def test_layers_match_reference_in_float32():
    """RMSNorm, RoPE and the causal mask on their own, fp32."""
    from repro.models import layers as JL
    jcfg, cfg = _configs("float32")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8, 4, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(8), (2, 8))
    np.testing.assert_allclose(
        layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()),
                          cfg.rope_theta).numpy(),
        np.asarray(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                 jcfg.rope_theta)), rtol=1e-5, atol=1e-6)
    h = rng.standard_normal((2, 8, 256)).astype(np.float32)
    scale = rng.standard_normal(256).astype(np.float32)
    np.testing.assert_allclose(
        layers.apply_norm({"scale": torch.from_numpy(scale)},
                          torch.from_numpy(h)).numpy(),
        np.asarray(JL.apply_norm(jcfg, {"scale": jnp.asarray(scale)},
                                 jnp.asarray(h))), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(layers.make_mask(9, "cpu").numpy(),
                                  np.asarray(JL.make_mask(9, "full")))


def test_pipeline_draws_the_reference_batches():
    jcfg, cfg = _configs("bfloat16")
    jp = JPipeline(jcfg, 3, 17, seed=11)
    tp = SyntheticTokenPipeline(cfg, 3, 17, seed=11)
    for _ in range(3):
        np.testing.assert_array_equal(jp.next_batch()["tokens"],
                                      tp.next_batch()["tokens"])
    assert jp.state == tp.state == {"seed": 11, "step": 3}
    tp.restore({"seed": 11, "step": 1})
    jp.restore({"seed": 11, "step": 1})
    got = tp.next_batch_on("cpu")["tokens"]
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), jp.next_batch()["tokens"])


def test_long_sequences_are_refused():
    """Past 2048 tokens attention takes the blocked online-softmax path,
    which trains through ``layers._Flash``: at S 2,049 its gradients equal
    those of the direct masked path (fp32, ``rtol=1e-4, atol=1e-5``: the
    two differ in summation order and in where the softmax normalises)
    instead of raising; without grad it runs too."""
    S = layers.DIRECT_SDPA_MAX_SEQ + 1
    rng = np.random.default_rng(9)
    qkv = [torch.from_numpy(rng.standard_normal((1, S, 2, 8))
                            .astype(np.float32)).requires_grad_(True)
           for _ in range(3)]
    dout = torch.from_numpy(rng.standard_normal((1, S, 16))
                            .astype(np.float32))
    out = layers.full_seq_sdpa(*qkv, kv_block=512)
    grads = torch.autograd.grad(out, qkv, dout)
    direct = layers._sdpa(*qkv, layers.make_mask(S, "cpu"))
    want = torch.autograd.grad(direct, qkv, dout)
    np.testing.assert_allclose(out.detach().numpy(),
                               direct.detach().numpy(), rtol=1e-4, atol=1e-5)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5)
    with torch.no_grad():
        assert layers.full_seq_sdpa(*qkv).shape == (1, S, 16)
