"""The port's recurrent blocks (RG-LRU, RWKV6) and their configs held
against the JAX package, and the checks every config of slice 14 shares.

The same numpy inputs, and the same JAX-initialised parameters carried
over by ``repro_torch.convert``, go through ``repro`` and ``repro_torch``
with ``device="cpu"``:

* RG-LRU: the log-depth scan (``rglru.linear_scan``) and ``rg_lru``
  against the reference's ``associative_scan``, fp32 within ``rtol=1e-5,
  atol=1e-6`` (another order of sums); the causal convolution and the
  carried state (``h``, ``conv``): a sequence cut in two and run with the
  state between equals the whole, within the same tolerance.
* RWKV6: ``chunked_wkv6`` against the reference's and against
  ``reference_wkv6`` (both packages), fp32 within ``rtol=1e-4,
  atol=1e-5`` (chunk-parallel and stepwise sums of up to T terms); the
  WKV state carried across a cut.
* recurrentgemma-2b and rwkv6-7b at ``smoke_variant``: the parameter
  tree, the fields, forward logits, the loss and every gradient leaf in
  fp32 (``tests/test_torch_model_zoo.py``'s tolerances, logits
  ``atol=1e-5``; rwkv6's gradients within ``1e-4`` of each leaf's
  largest entry, the chunked WKV's ``exp`` factors); prefill then decode
  past the window ring's wrap against the reference's caches and logits
  (``rtol=atol=1e-5``) and against the port's own forward over the whole
  sequence (``atol=1e-4``); greedy tokens equal to the reference's.
* rwkv6-7b in bf16, the port alone: a prefill of T - 16 tokens, then 16
  decode steps fed the next given tokens, gives last logits within a
  relative L2 error of 2e-2 of a forward over all T (the chunked form
  against the stepwise one, each rounding to bf16 where the reference
  does): the tolerance the card's phase 12c holds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_variant as jsmoke  # noqa: E402
from repro.core.distributed import _path_str  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import rglru as JR  # noqa: E402
from repro.models import rwkv6 as JW  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro_torch.configs import get_config, list_configs  # noqa: E402
from repro_torch.configs import smoke_variant  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core.tree import flatten_with_path, path_str  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import rglru, rwkv6  # noqa: E402
from repro_torch.serving import engine as TE  # noqa: E402

from test_torch_model_zoo import (BATCH, _batches, _configs, _f32,  # noqa
                                  _loss_and_grads, _params)

RECURRENT = ["recurrentgemma-2b", "rwkv6-7b"]


def _draw(shape, seed: int, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _np_tree(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _torch_tree(tree):
    return {k: torch.from_numpy(np.asarray(v).copy()) for k, v in
            tree.items()}


# ----------------------------------------------------------------- RG-LRU
def _rglru_params(seed: int):
    cfg = dataclasses.replace(jsmoke(jget_config("recurrentgemma-2b")),
                              dtype="float32")
    jp = JR.init_rglru_block(cfg, jax.random.PRNGKey(seed))
    return cfg, jp, _torch_tree(_np_tree(jp))


def test_linear_scan_matches_associative_scan():
    a = np.random.default_rng(0).uniform(0.2, 1.0, (2, 37, 8)) \
        .astype(np.float32)
    b = _draw((2, 37, 8), 1)

    def combine(c1, c2):
        return c1[0] * c2[0], c2[0] * c1[1] + c2[1]
    _a, want = jax.lax.associative_scan(combine, (jnp.asarray(a),
                                                  jnp.asarray(b)), axis=1)
    got = rglru.linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    # against the recurrence written out
    h, rows = np.zeros((2, 8), np.float32), []
    for t in range(37):
        h = a[:, t] * h + b[:, t]
        rows.append(h)
    np.testing.assert_allclose(got.numpy(), np.stack(rows, 1), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("T", [1, 16, 33])
def test_rg_lru_and_block_match_reference(T):
    cfg, jp, p = _rglru_params(2)
    u = _draw((2, T, cfg.d_rnn), T)
    h0 = _draw((2, cfg.d_rnn), T + 1)
    for h in (None, h0):
        want, wlast = JR.rg_lru(jp, jnp.asarray(u),
                                None if h is None else jnp.asarray(h))
        got, last = rglru.rg_lru(p, torch.from_numpy(u),
                                 None if h is None else torch.from_numpy(h))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(last.numpy(), np.asarray(wlast),
                                   rtol=1e-5, atol=1e-6)
    x = _draw((2, T, cfg.d_model), T + 2)
    want, (wh, wc) = JR.apply_rglru_block(cfg, jp, jnp.asarray(x))
    got, (h, c) = rglru.apply_rglru_block(cfg, p, torch.from_numpy(x))
    for g, w in ((got, want), (h, wh), (c, wc)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    assert h.dtype == torch.float32


def test_rglru_state_carries_across_a_cut():
    """The block on 24 tokens equals the block on 10 then, from its ``h``
    and ``conv``, on 14; and a convolution state of the last W - 1
    inputs."""
    cfg, _jp, p = _rglru_params(3)
    x = torch.from_numpy(_draw((2, 24, cfg.d_model), 4))
    whole, (h, conv) = rglru.apply_rglru_block(cfg, p, x)
    a, state = rglru.apply_rglru_block(cfg, p, x[:, :10])
    b, (h2, conv2) = rglru.apply_rglru_block(cfg, p, x[:, 10:], state)
    np.testing.assert_allclose(torch.cat([a, b], 1).numpy(), whole.numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h2.numpy(), h.numpy(), rtol=1e-5, atol=1e-6)
    assert torch.equal(conv2, conv)
    assert conv.shape == (2, cfg.conv_width - 1, cfg.d_rnn)
    u = x @ p["w_rec_in"]
    assert torch.equal(conv, u[:, -(cfg.conv_width - 1):])


# ------------------------------------------------------------------- RWKV6
def _wkv_inputs(B, T, H, hs, seed):
    r, k, v = (_draw((B, T, H, hs), seed + i, 0.5) for i in range(3))
    lw = -np.exp(_draw((B, T, H, hs), seed + 3, 0.5) - 0.6)
    # decays past the clamp, so the clamp is exercised
    lw[:, ::5] *= 20.0
    u = _draw((H, hs), seed + 4, 0.1)
    return r, k, v, lw.astype(np.float32), u


@pytest.mark.parametrize("T,chunk", [(16, 4), (32, 16), (12, 12)])
def test_chunked_wkv6_matches_reference(T, chunk):
    r, k, v, lw, u = _wkv_inputs(2, T, 3, 16, T)
    jargs = [jnp.asarray(a) for a in (r, k, v, lw, u)]
    targs = [torch.from_numpy(a) for a in (r, k, v, lw, u)]
    want, wS = JW.chunked_wkv6(*jargs, chunk)
    got, S = rwkv6.chunked_wkv6(*targs, chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(S.numpy(), np.asarray(wS), rtol=1e-4,
                               atol=1e-5)
    step, stepS = rwkv6.reference_wkv6(*targs)
    jstep, jstepS = JW.reference_wkv6(*jargs)
    for g, w in ((step, jstep), (stepS, jstepS), (got, jstep),
                 (S, jstepS)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)
    with pytest.raises(AssertionError, match="divisible"):
        rwkv6.chunked_wkv6(*targs, T + 1)


def test_wkv_state_carries_across_a_cut():
    r, k, v, lw, u = (torch.from_numpy(a) for a in _wkv_inputs(1, 20, 2, 8,
                                                               7))
    whole, S = rwkv6.reference_wkv6(r, k, v, lw, u)
    a, S1 = rwkv6.reference_wkv6(r[:, :12], k[:, :12], v[:, :12],
                                 lw[:, :12], u)
    b, S2 = rwkv6.reference_wkv6(r[:, 12:], k[:, 12:], v[:, 12:],
                                 lw[:, 12:], u, initial_state=S1)
    np.testing.assert_allclose(torch.cat([a, b], 1).numpy(), whole.numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(S2.numpy(), S.numpy(), rtol=1e-6, atol=1e-6)


def test_time_and_channel_mix_match_reference():
    jcfg, cfg = _configs("rwkv6-7b")
    jparams, params = _params(jcfg, 8)
    jp = jax.tree_util.tree_map(lambda a: a[0],
                                jparams["groups"][0][0])
    p = jax.tree_util.tree_map(lambda t: t[0], params["groups"][0][0])
    x = _draw((2, 8, cfg.d_model), 9)
    last = _draw((2, cfg.d_model), 10)
    S0 = _draw((2, cfg.d_model // 64, 64, 64), 11, 0.1)
    for state, decode in ((None, False), (S0, True)):
        want, (wx, wS) = JW.time_mix(
            jcfg, jp["tmix"], jnp.asarray(x), jnp.asarray(last),
            None if state is None else jnp.asarray(state), decode=decode)
        got, (gx, gS) = rwkv6.time_mix(
            cfg, p["tmix"], torch.from_numpy(x), torch.from_numpy(last),
            None if state is None else torch.from_numpy(state),
            decode=decode)
        for g, w in ((got, want), (gx, wx), (gS, wS)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                       atol=1e-5)
    want, wx = JW.channel_mix(jcfg, jp["cmix"], jnp.asarray(x),
                              jnp.asarray(last))
    got, gx = rwkv6.channel_mix(cfg, p["cmix"], torch.from_numpy(x),
                                torch.from_numpy(last))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    assert torch.equal(gx, torch.from_numpy(x[:, -1]))


# ------------------------------------------------- every config of slice 14
SLICE14 = ["dbrx-132b", "llama4-maverick-400b-a17b", "paligemma-3b",
           "recurrentgemma-2b", "rwkv6-7b"]


def check_tree_and_fields(name: str) -> None:
    """The parameter tree of ``smoke_variant`` equals ``jax.eval_shape(
    init_params)`` leaf for leaf, and every shared field is equal."""
    jcfg, cfg = _configs(name, "bfloat16")
    want = [(_path_str(k), tuple(v.shape), str(v.dtype)) for k, v in
            jax.tree_util.tree_flatten_with_path(jax.eval_shape(
                lambda: JM.init_params(jcfg, jax.random.PRNGKey(0))))[0]]
    got = [(path_str(k), tuple(v.shape), v.dtype) for k, v in
           flatten_with_path(TM.param_shapes(cfg))[0]]
    assert got == want
    for full, ref in ((get_config(name), jget_config(name)), (cfg, jcfg)):
        for f in dataclasses.fields(ModelConfig):
            assert getattr(full, f.name) == getattr(ref, f.name), f.name
    assert name in list_configs()


def check_forward_loss_and_grads(name: str, seed: int,
                                 grad_atol_share: float = 0.0) -> None:
    """fp32 logits (``atol=1e-5``), the loss with the MoE aux
    (``rel=1e-5``) and every gradient leaf (``rtol=1e-5, atol=1e-6``)
    against ``jax.value_and_grad``, as ``tests/test_torch_model_zoo.py``
    holds the attention family; with ``grad_atol_share``, a leaf's
    ``atol`` is that share of its largest entry instead."""
    jcfg, cfg = _configs(name)
    jlogits, jloss, jgrads, logits, loss, grads = _loss_and_grads(
        jcfg, cfg, seed=seed)
    assert tuple(logits.shape) == jlogits.shape
    np.testing.assert_allclose(_f32(logits), _f32(jlogits), rtol=1e-5,
                               atol=1e-5)
    assert loss == pytest.approx(jloss, rel=1e-5, abs=1e-6)
    assert len(grads) == len(jgrads)
    for (path, g), jg in zip(grads, jgrads):
        want = _f32(jg)
        atol = grad_atol_share * np.abs(want).max() if grad_atol_share \
            else 1e-6
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-5, atol=atol,
                                   err_msg=path)


def check_decode(name: str, prompt: int, n_new: int, seed: int,
                 against_forward: bool = True, **kw) -> None:
    """Prefill ``prompt`` tokens, then decode ``n_new`` fed the next given
    tokens: every cache leaf and every step's logits against the
    reference's ``forward(collect_caches=True)`` and decode step
    (``rtol=atol=1e-5``), and, with ``against_forward``, each step's
    logits against the port's forward over the whole sequence at that
    position (``atol=1e-4``; the MoE configs route by groups, so a
    token's capacity differs between a forward and a decode step there).
    Decode positions count the prefix-LM's prefix."""
    jcfg, cfg = _configs(name, max_decode_len=n_new, **kw)
    jparams, params = _params(jcfg, seed)
    jb, tb = _batches(jcfg, cfg, prompt + n_new, seed + 1)
    cut = lambda b, lo, hi: {k: v[:, lo:hi] if k == "tokens" else v  # noqa
                             for k, v in b.items()}
    _l, _a, jcaches = JM.forward(jcfg, jparams, cut(jb, 0, prompt),
                                 collect_caches=True)
    with torch.no_grad():
        _l, caches = TM.forward(cfg, params, cut(tb, 0, prompt),
                                collect_caches=True)
        full = TM.forward(cfg, params, tb)
    jdecode = jax.jit(JE.make_decode_step(jcfg))
    decode = TE.make_decode_step(cfg)
    npre = cfg.n_prefix_embeds
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
                                   jcaches, pos + npre)
        logits, caches = decode(params, tb["tokens"][:, pos:pos + 1], caches,
                                pos + npre)
        np.testing.assert_allclose(_f32(logits), _f32(jlogits), rtol=1e-5,
                                   atol=1e-5, err_msg=f"logits, step {i}")
        if against_forward:
            np.testing.assert_allclose(
                _f32(logits[:, 0]), _f32(full[:, npre + pos]), rtol=1e-4,
                atol=1e-4, err_msg=f"decode against forward, step {i}")


def check_greedy(name: str, seed: int) -> None:
    jcfg, cfg = _configs(name)
    jparams, params = _params(jcfg, seed)
    jb, tb = _batches(jcfg, cfg, 20, seed + 1)
    want = np.asarray(JE.greedy_generate(jcfg, jparams, jb, 6))
    got = TE.greedy_generate(cfg, params, tb, 6)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape \
        == (BATCH, 6)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", RECURRENT)
def test_param_tree_and_fields_match_reference(name):
    check_tree_and_fields(name)


@pytest.mark.parametrize("name,grad_atol_share", [("recurrentgemma-2b", 0.0),
                                                  ("rwkv6-7b", 1e-4)])
def test_float32_forward_loss_and_grads_match_reference(name,
                                                        grad_atol_share):
    """rwkv6's gradients are held within ``1e-4`` of each leaf's largest
    entry: the chunk-parallel WKV multiplies by ``exp(±cumulative
    log-decay)``, up to e^20 within a chunk of 4 at the clamp, so its
    rounding follows the largest terms (about 2e-5 of a leaf's largest
    entry, measured)."""
    check_forward_loss_and_grads(name, seed=13,
                                 grad_atol_share=grad_atol_share)


@pytest.mark.parametrize("name", RECURRENT)
def test_prefill_then_decode_matches_reference_and_forward(name):
    """recurrentgemma: a 20-token prompt and 12 steps wrap the 16-slot
    window ring; rwkv: a 20-token prompt (5 chunks of 4) then 12 steps of
    the stepwise recurrence."""
    check_decode(name, prompt=20, n_new=12, seed=14)


@pytest.mark.parametrize("name", RECURRENT)
def test_greedy_tokens_equal_reference(name):
    check_greedy(name, seed=15)


def test_rwkv_bf16_decode_continues_its_prefill():
    """The port alone, in bf16 as on the card: a prefill of 48 tokens (12
    chunks of 4) and 16 decode steps fed tokens 48-63 give last logits
    within a relative L2 error of 2e-2 of a forward over all 64."""
    cfg = smoke_variant(get_config("rwkv6-7b"))
    assert cfg.dtype == "bfloat16"
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 64), dtype=np.int32))
    with torch.no_grad():
        want = TM.forward(cfg, params, {"tokens": tokens})[:, -1].float()
        _l, caches = TM.forward(cfg, params, {"tokens": tokens[:, :48]},
                                collect_caches=True)
        for pos in range(48, 64):
            logits, caches = TM.decode(cfg, params,
                                       {"tokens": tokens[:, pos:pos + 1]},
                                       caches, pos)
    got = logits[:, -1].float()
    err = float((got - want).norm() / want.norm())
    assert err < 2e-2, err


def test_cache_templates_of_the_recurrent_blocks():
    _j, cfg = _configs("recurrentgemma-2b")
    tmpl = TE.cache_template(cfg, 3, 40)
    assert {k: (tuple(t.shape), t.dtype) for k, t in tmpl[0][0].items()} \
        == {"h": ((1, 3, 256), torch.float32),
            "conv": ((1, 3, 3, 256), torch.float32)}
    assert tuple(tmpl[0][1]["k"].shape) == (1, 3, 16, 1, 64)
    cfg = smoke_variant(get_config("rwkv6-7b"))
    tmpl = TE.cache_template(cfg, 2, 40)
    assert {k: (tuple(t.shape), t.dtype) for k, t in tmpl[0][0].items()} \
        == {"x_t": ((1, 2, 256), torch.bfloat16),
            "S": ((1, 2, 4, 64, 64), torch.float32),
            "x_c": ((1, 2, 256), torch.bfloat16)}
    jcfg = jsmoke(jget_config("rwkv6-7b"))
    want = jax.tree_util.tree_leaves(JE.cache_template(jcfg, 2, 40))
    assert [(tuple(t.shape), str(t.dtype).split(".")[-1]) for t in
            jax.tree_util.tree_leaves(tmpl)] == \
        [(tuple(w.shape), str(w.dtype)) for w in want]
