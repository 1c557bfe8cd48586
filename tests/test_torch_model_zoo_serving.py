"""The port's attention-family model zoo held against the JAX package:
bf16 training, decode over ring caches, generation and the layers.

The same inputs as ``tests/test_torch_model_zoo.py`` (its helpers), with
``device="cpu"``:

* bf16 loss and gradients for gemma3 and musicgen (the two the card
  runs) within ``2e-2`` relative (loss) and ``2e-2`` relative L2 error a
  gradient leaf, as ``tests/test_torch_model.py`` holds llama (a key
  bias's error relative to its module's query-bias gradient: the part of
  it the softmax sees is a cancellation's remainder);
* prefill then token-by-token decode past the ring's wrap (window and
  chunk 16, a 20-token prompt, 14 new tokens, so the window ring wraps
  and the chunk ring restarts at 32): every cache leaf and every step's
  logits against ``forward(collect_caches=True)`` and ``decode``, fp32
  within ``rtol=1e-5, atol=1e-5`` (``tests/test_torch_serving.py``'s);
* ``greedy_generate``'s tokens equal the reference's for gemma3 (window
  and full caches) and musicgen (codebooks, memory), fp32;
* the layers on their own: layernorm, ``gelu_mlp`` and ``relu_sq`` with
  and without biases, codebook embedding and logits, the ``window`` and
  ``chunked`` masks, fp32 within ``rtol=atol=1e-5`` (logits ``atol=1e-4``:
  sums of 256 products of unit-scale values).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")


from repro.models import layers as JL
from repro.models import model as JM
from repro.serving import engine as JE
from repro_torch.models import layers
from repro_torch.models import model as TM
from repro_torch.serving import engine as TE

from test_torch_model_zoo import (BATCH, CHUNKED, _batches, _configs, _f32,
                                  _loss_and_grads, _params)


@pytest.mark.parametrize("name", ["gemma3-27b", "musicgen-medium"])
def test_bfloat16_loss_and_grads_match_reference(name):
    jcfg, cfg = _configs(name, "bfloat16")
    _jl, jloss, jgrads, _l, loss, grads = _loss_and_grads(jcfg, cfg, seed=4)
    assert loss == pytest.approx(jloss, rel=2e-2)
    norms = {path: np.linalg.norm(_f32(jg))
             for (path, _g), jg in zip(grads, jgrads)}
    for (path, g), jg in zip(grads, jgrads):
        want = _f32(jg)
        assert g.dtype == (torch.float32 if path.startswith("ln")
                           or "/ln" in path else torch.bfloat16), path
        # the softmax does not see the part of a key bias that is the same
        # for every key, so a key bias's gradient is what is left of a
        # cancellation (exactly 0 without RoPE, in cross-attention): its
        # error is measured against its module's query-bias gradient
        scale = norms[path]
        if path.endswith("/bk"):
            scale = max(scale, norms[path[:-2] + "bq"])
        err = np.linalg.norm(g.float().numpy() - want) / scale
        assert err < 2e-2, (path, err)


@pytest.mark.parametrize("name,kw", [("gemma3-27b", {}),
                                     ("starcoder2-7b", {}),
                                     ("gemma3-27b", CHUNKED),
                                     ("musicgen-medium", {})],
                         ids=["gemma3-27b", "starcoder2-7b",
                              "gemma3-27b-chunked", "musicgen-medium"])
def test_decode_past_the_ring_wrap_matches_reference(name, kw):
    prompt, n_new = 20, 14
    jcfg, cfg = _configs(name, max_decode_len=n_new, **kw)
    assert (cfg.window or cfg.chunk or 16) == 16 < prompt
    jparams, params = _params(jcfg, seed=5)
    jb, tb = _batches(jcfg, cfg, prompt + n_new, seed=6)
    cut = lambda b, lo, hi: {k: v[:, lo:hi] if k == "tokens" else v
                             for k, v in b.items()}
    _l, _a, jcaches = JM.forward(jcfg, jparams, cut(jb, 0, prompt),
                                 collect_caches=True)
    with torch.no_grad():
        _l, caches = TM.forward(cfg, params, cut(tb, 0, prompt),
                                collect_caches=True)
    jdecode = jax.jit(JE.make_decode_step(jcfg))
    decode = TE.make_decode_step(cfg)
    for i in range(n_new + 1):
        jl = jax.tree_util.tree_leaves(jcaches)
        tl = jax.tree_util.tree_leaves(caches)
        assert len(jl) == len(tl)
        for c, jc in zip(tl, jl):
            assert tuple(c.shape) == jc.shape
            np.testing.assert_allclose(_f32(c), _f32(jc), rtol=1e-5,
                                       atol=1e-5, err_msg=f"cache, step {i}")
        if i == n_new:
            break
        pos = prompt + i
        jlogits, jcaches = jdecode(jparams, jb["tokens"][:, pos:pos + 1],
                                   jcaches, pos)
        logits, caches = decode(params, tb["tokens"][:, pos:pos + 1], caches,
                                pos)
        np.testing.assert_allclose(_f32(logits), _f32(jlogits), rtol=1e-5,
                                   atol=1e-5, err_msg=f"logits, step {i}")


@pytest.mark.parametrize("name", ["gemma3-27b", "musicgen-medium"])
def test_greedy_tokens_equal_reference(name):
    jcfg, cfg = _configs(name)
    jparams, params = _params(jcfg, seed=7)
    jb, tb = _batches(jcfg, cfg, 20, seed=8)
    want = np.asarray(JE.greedy_generate(jcfg, jparams, jb, 6))
    got = TE.greedy_generate(cfg, params, tb, 6)
    assert got.dtype == torch.int32
    assert tuple(got.shape) == want.shape == (
        (BATCH, 6, 4) if cfg.n_codebooks else (BATCH, 6))
    np.testing.assert_array_equal(got.numpy(), want)


def test_cache_templates_of_every_block_type():
    _j, cfg = _configs("musicgen-medium")
    tmpl = TE.cache_template(cfg, 3, 40)
    assert {k: tuple(t.shape) for k, t in tmpl[0][0].items()} == {
        "k": (1, 3, 40, 2, 64), "v": (1, 3, 40, 2, 64),
        "mk": (1, 3, 4, 2, 64), "mv": (1, 3, 4, 2, 64)}
    _j, cfg = _configs("gemma3-27b", **CHUNKED)
    shapes = [tuple(t.shape) for t in jax.tree_util.tree_leaves(
        TE.cache_template(cfg, 2, 40))]
    assert shapes == [(1, 2, 16, 2, 64)] * 2 + [(1, 2, 40, 2, 64)] * 2
    assert [tuple(t.shape) for t in jax.tree_util.tree_leaves(
        TE.cache_template(cfg, 2, 8))][0] == (1, 2, 8, 2, 64)


def test_layers_match_reference_in_float32():
    """Layernorm, the biased projections, ``gelu_mlp`` and ``relu_sq``,
    codebook embeddings and logits, and the masks, each on its own."""
    rng = np.random.default_rng(10)
    draw = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa
    jcfg, cfg = _configs("starcoder2-7b")
    x = draw(2, 8, 256) * 3 + 1
    p = {"scale": draw(256), "bias": draw(256)}
    np.testing.assert_allclose(
        layers.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                          torch.from_numpy(x)).numpy(),
        np.asarray(JL.apply_norm(jcfg, {k: jnp.asarray(v)
                                        for k, v in p.items()},
                                 jnp.asarray(x))), rtol=1e-5, atol=1e-5)
    for act, keys in (("gelu_mlp", ("w_up", "w_down", "b_up", "b_down")),
                      ("relu_sq", ("w_up", "w_down", "w_gate"))):
        c = dataclasses.replace(cfg, act=act)
        shapes = {"w_up": (256, 64), "w_gate": (256, 64),
                  "w_down": (64, 256), "b_up": (64,), "b_down": (256,)}
        p = {k: draw(*shapes[k]) * 0.1 for k in keys}
        np.testing.assert_allclose(
            layers.apply_ffn(c, {k: torch.from_numpy(v)
                                 for k, v in p.items()},
                             torch.from_numpy(x)).numpy(),
            np.asarray(JL.apply_ffn(dataclasses.replace(jcfg, act=act),
                                    {k: jnp.asarray(v)
                                     for k, v in p.items()},
                                    jnp.asarray(x))),
            rtol=1e-5, atol=1e-5, err_msg=act)
    jcfg, cfg = _configs("musicgen-medium")
    emb = {"embed": draw(4 * cfg.vocab, 256), "head": draw(256,
                                                            4 * cfg.vocab)}
    toks = rng.integers(0, cfg.vocab, (2, 5, 4)).astype(np.int32)
    temb = {k: torch.from_numpy(v) for k, v in emb.items()}
    jemb = {k: jnp.asarray(v) for k, v in emb.items()}
    h = layers.embed_tokens(cfg, temb, torch.from_numpy(toks))
    np.testing.assert_allclose(
        h.numpy(), np.asarray(JL.embed_tokens(jcfg, jemb, jnp.asarray(toks))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        layers.logits_from_hidden(cfg, temb, h).numpy(),
        np.asarray(JL.logits_from_hidden(jcfg, jemb, jnp.asarray(h.numpy()))),
        rtol=1e-5, atol=1e-4)
    for kind, kw in (("window", {"window": 5}), ("chunked", {"chunk": 4})):
        np.testing.assert_array_equal(
            layers.make_mask(13, "cpu", kind, **kw).numpy(),
            np.asarray(JL.make_mask(13, kind, **kw)))
