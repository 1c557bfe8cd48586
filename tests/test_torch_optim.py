"""The port's in-place AdamW held against ``repro.optim.adamw``.

Same numpy inputs (smoke-size llama3.2-1b params, seeded gradients) go
through both for three steps. Masters, m and v are fp32 computed in a
different operation order (PyTorch's pow and reductions against XLA's):
rtol 1e-6, atol 1e-7. bf16 params are compared where the masters they
were cast from agree bit for bit.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.models.model import init_params as jinit_params
from repro.optim import adamw as jadamw
from repro_torch.convert import from_numpy_state, to_numpy_state
from repro_torch.core.tree import leaves
from repro_torch.optim import adamw


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_adamw_matches_reference_over_three_steps():
    cfg = jsmoke(jget_config("llama3.2-1b"))
    jparams = _np(jinit_params(cfg, jax.random.PRNGKey(0)))
    params = from_numpy_state(jparams, "cpu")
    opt = adamw.init_opt_state(params)
    jopt = jadamw.init_opt_state(jax.tree_util.tree_map(jnp.asarray,
                                                        jparams))
    hp = adamw.AdamWConfig()
    jhp = jadamw.AdamWConfig()
    rng = np.random.default_rng(0)
    ptrs = [t.data_ptr() for t in leaves((params, opt))]
    jp = jax.tree_util.tree_map(jnp.asarray, jparams)
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda x: (rng.standard_normal(x.shape) * 0.05)
            .astype(x.dtype), jparams)
        jp, jopt = jadamw.apply_updates(
            jp, jopt, jax.tree_util.tree_map(jnp.asarray, grads), jhp)
        adamw.apply_updates(params, opt, from_numpy_state(grads, "cpu"), hp)
    # in place: every buffer of params and optimizer state is the original
    assert [t.data_ptr() for t in leaves((params, opt))] == ptrs
    assert int(opt["count"]) == int(jopt["count"]) == 3
    ours = to_numpy_state(opt)
    for k in ("master", "m", "v"):
        for a, b in zip(jax.tree_util.tree_leaves(ours[k]),
                        jax.tree_util.tree_leaves(_np(jopt[k]))):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    for p, jpl, m, jm in zip(
            jax.tree_util.tree_leaves(to_numpy_state(params)),
            jax.tree_util.tree_leaves(_np(jp)),
            jax.tree_util.tree_leaves(ours["master"]),
            jax.tree_util.tree_leaves(_np(jopt["master"]))):
        same = m.view(np.uint32) == jm.view(np.uint32)
        assert same.mean() > 0.5
        want = np.asarray(jpl)
        if want.dtype == ml_dtypes.bfloat16:
            want = want.view(np.uint16)
        np.testing.assert_array_equal(p[same], want[same])
        # and every param is exactly its own master cast to bf16/fp32
        cast = torch.from_numpy(m).to(torch.bfloat16).view(torch.int16) \
            .numpy().view(np.uint16) if p.dtype == np.uint16 else m
        np.testing.assert_array_equal(p, cast)


def test_init_opt_state_shapes_and_dtypes():
    params = {"w": torch.ones(3, 2, dtype=torch.bfloat16),
              "b": (torch.zeros(4, dtype=torch.float32),)}
    opt = adamw.init_opt_state(params)
    assert opt["master"]["w"].dtype == torch.float32
    assert torch.equal(opt["master"]["w"], torch.ones(3, 2))
    assert opt["master"]["w"].data_ptr() != params["w"].data_ptr()
    assert opt["m"]["b"][0].shape == (4,) and opt["v"]["w"].shape == (3, 2)
    assert opt["count"].shape == () and opt["count"].dtype == torch.int32


def test_grad_clip_scales_large_gradients():
    params = {"w": torch.zeros(4, dtype=torch.float32)}
    opt = adamw.init_opt_state(params)
    hp = adamw.AdamWConfig(lr=1.0, weight_decay=0.0)
    adamw.apply_updates(params, opt, {"w": torch.full((4,), 100.0)}, hp)
    # clipped to unit norm: g = 0.5 each; first Adam step moves by ~lr
    np.testing.assert_allclose(opt["m"]["w"].numpy(), 0.05, rtol=1e-6)
    np.testing.assert_allclose(params["w"].numpy(), -1.0, rtol=1e-5)


def test_state_conversion_needs_a_device_and_keeps_bytes():
    """The caller names the device (the port runs on the card unless asked
    for the CPU); bfloat16 crosses as its 16-bit pattern both ways."""
    bits = np.arange(6, dtype=np.uint16).reshape(2, 3) + 0x3F80
    tree = {"w": bits.view(ml_dtypes.bfloat16), "n": 3}
    with pytest.raises(TypeError):
        from_numpy_state(tree)
    t = from_numpy_state(tree, "cpu")
    assert t["w"].dtype == torch.bfloat16 and t["w"].device.type == "cpu"
    assert t["n"] == 3
    np.testing.assert_array_equal(to_numpy_state(t)["w"], bits)
