"""The port's serving path held against the JAX package.

The same JAX-initialised parameters (``repro.models.model.init_params``,
carried over by ``repro_torch.convert``) and the same numpy prompt tokens
go through ``repro.serving.engine`` and ``repro_torch.serving.engine`` at
``smoke_variant(llama3.2-1b)``: prefill at S 64 (the direct attention
path) and S 2,100 (past 2,048 tokens: the blocked path), decode steps over
the cache, and greedy generation.

Tolerances, and why:

* float32 prefill: last-position logits within ``rtol=atol=1e-5``
  elementwise (measured up to 1.6e-6: the same algorithm summed in
  another order). Caches within ``1e-4`` relative error in their L2 norm:
  k is rotated by RoPE in fp32 at angles up to ``2,100`` radians, where
  one ulp of the angle is ``2.4e-4``, and XLA and ATen evaluate ``sin``
  and ``cos`` of the same angle to different last bits (measured
  ``1.6e-5``).
* bfloat16 prefill: logits and caches within ``2e-2`` relative error in
  their L2 norm, the bound of ``tests/test_torch_model.py``: the bf16
  matrix products and elementwise ops round at other points in XLA and in
  ATen on the CPU, each rounding ``2^-8`` relative (measured up to
  ``7.8e-3``).
* float32 decode steps: logits within ``rtol=atol=1e-5``.
* Greedy tokens: equal.

``load_params_for_serving`` restores the ``model`` domain of a keyframe
and of a delta step, written by ``repro`` and by the port, bit for bit
against the saved params, reading fewer bytes than a full restore.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.core as J
from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.models import model as JM
from repro.serving import engine as JE
from repro.storage.repository import CheckpointRepository as JRepository

import repro_torch.core as T
from repro_torch.configs import get_config, smoke_variant
from repro_torch.convert import from_numpy_state, to_numpy_state
from repro_torch.core.tree import flatten_with_path, leaves
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import model as TM
from repro_torch.models.model import param_shapes
from repro_torch.serving import engine as TE
from repro_torch.storage import CheckpointRepository

BATCH = 2


def _configs(dtype: str, **kw):
    jcfg = dataclasses.replace(jsmoke(jget_config("llama3.2-1b")),
                               dtype=dtype, **kw)
    cfg = dataclasses.replace(smoke_variant(get_config("llama3.2-1b")),
                              dtype=dtype, **kw)
    return jcfg, cfg


def _params(jcfg, seed: int):
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    return jparams, from_numpy_state(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu")


def _tokens(cfg, S: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (BATCH, S)).astype(np.int32)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel(a, b) -> float:
    a, b = _f32(a), _f32(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("S", [64, 2100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_matches_reference(S, dtype):
    jcfg, cfg = _configs(dtype, max_decode_len=4)
    jparams, params = _params(jcfg, seed=0)
    toks = _tokens(cfg, S, seed=S)
    jlogits, jcaches = jax.jit(JE.make_prefill_step(jcfg))(
        jparams, {"tokens": jnp.asarray(toks)})
    fa.KERNEL.launches = 0
    logits, caches = TE.make_prefill_step(cfg)(
        params, {"tokens": torch.from_numpy(toks)})
    assert fa.KERNEL.launches == 0        # the CPU runs the plain version
    assert logits.shape == (BATCH, 1, cfg.vocab)
    got_c = jax.tree_util.tree_leaves(caches)
    want_c = jax.tree_util.tree_leaves(jcaches)
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda _: 0, caches)) == \
        jax.tree_util.tree_structure(
            jax.tree_util.tree_map(lambda _: 0, jcaches))
    for c, jc in zip(got_c, want_c):
        assert tuple(c.shape) == jc.shape == (1, BATCH, S + 4, 2, cfg.hd)
        assert not c[:, :, S:].any()      # decode headroom starts empty
    if dtype == "float32":
        np.testing.assert_allclose(_f32(logits), _f32(jlogits), rtol=1e-5,
                                   atol=1e-5)
        for c, jc in zip(got_c, want_c):
            assert _rel(c, jc) < 1e-4
    else:
        assert _rel(logits, jlogits) < 2e-2
        for c, jc in zip(got_c, want_c):
            assert _rel(c, jc) < 2e-2


def test_decode_steps_match_reference():
    """Prefill, then four teacher-forced decode steps at positions S..S+3:
    each step's logits against ``repro``'s, fp32."""
    S, n = 64, 4
    jcfg, cfg = _configs("float32", max_decode_len=n)
    jparams, params = _params(jcfg, seed=1)
    toks = _tokens(cfg, S + n, seed=2)
    _l, jcaches = jax.jit(JE.make_prefill_step(jcfg))(
        jparams, {"tokens": jnp.asarray(toks[:, :S])})
    _l, caches = TE.make_prefill_step(cfg)(
        params, {"tokens": torch.from_numpy(toks[:, :S])})
    jdecode = jax.jit(JE.make_decode_step(jcfg))
    decode = TE.make_decode_step(cfg)
    for i in range(n):
        tok = toks[:, S + i:S + i + 1]
        jlogits, jcaches = jdecode(jparams, jnp.asarray(tok), jcaches,
                                   S + i)
        logits, caches = decode(params, torch.from_numpy(tok), caches,
                                S + i)
        np.testing.assert_allclose(_f32(logits), _f32(jlogits), rtol=1e-5,
                                   atol=1e-5, err_msg=f"step {i}")


def test_decode_agrees_with_full_forward():
    """Decoding token by token into the cache gives the logits of a full
    forward over the whole sequence (fp32, within ``rtol=atol=1e-5``):
    slot ``S + i`` and RoPE at ``S + i`` line up."""
    S, n = 40, 5
    _j, cfg = _configs("float32", max_decode_len=n)
    params = TM.init_params(cfg, torch.Generator().manual_seed(4), "cpu")
    toks = torch.from_numpy(_tokens(cfg, S + n, seed=5))
    with torch.no_grad():
        full = TM.forward(cfg, params, {"tokens": toks})
    _l, caches = TE.make_prefill_step(cfg)(params, {"tokens": toks[:, :S]})
    decode = TE.make_decode_step(cfg)
    for i in range(n):
        logits, caches = decode(params, toks[:, S + i:S + i + 1], caches,
                                S + i)
        np.testing.assert_allclose(logits[:, 0].numpy(),
                                   full[:, S + i].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=f"step {i}")
    with pytest.raises(ValueError, match="outside the cache"):
        decode(params, toks[:, :1], caches, S + n)


@pytest.mark.parametrize("S", [64, 2100])
def test_greedy_tokens_equal_reference(S):
    jcfg, cfg = _configs("bfloat16")
    jparams, params = _params(jcfg, seed=6)
    toks = _tokens(cfg, S, seed=7)
    want = np.asarray(JE.greedy_generate(
        jcfg, jparams, {"tokens": jnp.asarray(toks)}, 8))
    got = TE.greedy_generate(cfg, params, {"tokens": torch.from_numpy(toks)},
                             8)
    assert got.dtype == torch.int32 and got.shape == (BATCH, 8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_cache_templates():
    _j, cfg = _configs("bfloat16")
    tmpl = TE.cache_template(cfg, 3, 10)
    shapes = [(tuple(t.shape), t.dtype, t.device.type) for t in leaves(tmpl)]
    assert shapes == [((1, 3, 10, 2, cfg.hd), torch.bfloat16, "meta")] * 4
    zeros = TE.zero_caches(cfg, 3, 10, device="cpu")
    assert all(not t.any() and t.device.type == "cpu" for t in leaves(zeros))
    # a recurrent block's cache is its carried state (slice 14), an
    # unknown block type has none
    rec = TE.cache_template(dataclasses.replace(
        cfg, layer_groups=((("rec",), 1),)), 1, 4)
    assert {k: tuple(t.shape) for k, t in rec[0][0].items()} == {
        "h": (1, 1, cfg.d_rnn), "conv": (1, 1, cfg.conv_width - 1,
                                         cfg.d_rnn)}
    with pytest.raises(ValueError, match="mamba"):
        TE.cache_template(dataclasses.replace(
            cfg, layer_groups=((("mamba",), 1),)), 1, 4)


# ------------------------------------------------------ load for serving
def _states():
    """{step: numpy state}: smoke-size bf16 params and fp32 master/m/v,
    step 2 changing half of every tensor as a training step would."""
    cfg = smoke_variant(get_config("llama3.2-1b"))
    specs, unflatten = flatten_with_path(param_shapes(cfg))
    rng = np.random.default_rng(8)

    def draw(spec):
        x = rng.standard_normal(spec.shape).astype(np.float32)
        return x.astype(ml_dtypes.bfloat16) if spec.dtype == "bfloat16" \
            else x
    flat = [draw(spec) for _p, spec in specs]
    opt = [rng.standard_normal(x.shape).astype(np.float32) for x in flat]
    out = {}
    for step in (1, 2):
        if step == 2:
            for i, x in enumerate(flat):
                x = x.copy()
                hit = rng.random(x.shape) < 0.5
                x[hit] = (x[hit].astype(np.float32) + 1e-2).astype(x.dtype)
                flat[i] = x
        out[step] = {"model": unflatten(list(flat)),
                     "optimizer": {k: unflatten(list(opt))
                                   for k in ("master", "m", "v")},
                     "meta": {"step": step}}
    return out


def _policy(mod):
    return mod.CheckpointPolicy(
        engine=mod.EnginePolicy(host_cache_bytes=64 << 20),
        delta=mod.DeltaPolicy(keyframe_every=3))


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_load_params_for_serving_restores_model_domain(tmp_path, writer):
    states = _states()
    if writer == "repro":
        mgr = J.CheckpointManager.from_policy(str(tmp_path), _policy(J))
        for step in (1, 2):
            mgr.save(step, jax.tree_util.tree_map(
                lambda x: jnp.asarray(x) if isinstance(x, np.ndarray)
                else x, states[step]))
    else:
        mgr = T.CheckpointManager.from_policy(str(tmp_path), _policy(T),
                                              device="cpu")
        for step in (1, 2):
            mgr.save(step, from_numpy_state(states[step], "cpu"))
    mgr.wait_for_persist()
    mgr.wait_for_commit()
    assert not mgr.commit_errors
    mgr.close()
    repo = CheckpointRepository(str(tmp_path), device="cpu")
    assert repo.chain_steps(2) == [1, 2]       # keyframe, then a delta
    template = from_numpy_state(states[1]["model"], "cpu")
    for step in (2, 1, None):
        params, stats = TE.load_params_for_serving(str(tmp_path), template,
                                                   step=step)
        want = states[step or 2]["model"]
        for a, b in zip(leaves(to_numpy_state(params)),
                        jax.tree_util.tree_leaves(want)):
            b = np.asarray(b)
            np.testing.assert_array_equal(
                a, b.view(np.uint16) if b.dtype == ml_dtypes.bfloat16
                else b)
        _full, full_stats, _s = T.restore_from_repository(
            repo, from_numpy_state(states[1], "cpu"), step=step or 2)
        assert 0 < stats.bytes_read < full_stats.bytes_read


def test_serving_refuses_unported_sources(tmp_path):
    """The JAX package's repository and anything that is not the port's
    fleet fabric are refused (tiered repositories and ``fleet=`` are
    served in ``tests/test_torch_fleet.py``)."""
    _j, cfg = _configs("bfloat16")
    template = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(TypeError, match="fleet"):
        TE.load_params_for_serving(str(tmp_path), template, fleet=object())
    with pytest.raises(TypeError, match="repro_torch CheckpointRepository"):
        TE.load_params_for_serving(str(tmp_path), template,
                                   repository=JRepository(str(tmp_path)))
