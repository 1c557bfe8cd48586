"""The trainer's two halves, ``make_grad_step`` and ``make_update_step``,
held against the JAX package's and against the fused ``make_train_step``.

The same JAX-initialised parameters (carried over by
``repro_torch.convert``) and the same batch, fp32 on the CPU:

* ``grad_step(params, batch) -> (grads, loss)`` gives the reference's
  loss and every gradient leaf within the zoo tests' tolerance
  (``rtol=1e-5, atol=1e-6``; XLA and ATen sum in other orders), for a
  dense config and for the MoE one (the router's aux loss in the loss);
* ``update_step(params, opt_state, grads)`` updates the very tensors it
  is given, in place (the counterpart of the reference's donation), and
  returns them; from the same inputs its params and state are bit-equal
  to the fused step's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_variant as jsmoke  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.training import loop as jloop  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.convert import from_numpy_state  # noqa: E402
from repro_torch.core.tree import leaves, map_leaves  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, init_opt_state  # noqa: E402
from repro_torch.training.loop import (Trainer, make_grad_step,  # noqa: E402
                                       make_train_step, make_update_step)

BATCH, SEQ = 2, 32


def _inputs(name):
    jcfg = dataclasses.replace(jsmoke(jget_config(name)), dtype="float32")
    cfg = dataclasses.replace(smoke_variant(get_config(name)),
                              dtype="float32")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params_np = jax.tree_util.tree_map(np.asarray, jparams)
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab, (BATCH, SEQ)).astype(np.int32)
    return jcfg, cfg, jparams, params_np, tokens


def _trainable(params_np):
    return map_leaves(lambda t: t.requires_grad_(True),
                      from_numpy_state(params_np, "cpu"))


@pytest.mark.parametrize("name", ["llama3.2-1b", "dbrx-132b"])
def test_grad_step_matches_reference(name):
    jcfg, cfg, jparams, params_np, tokens = _inputs(name)
    jgrads, jloss = jloop.make_grad_step(jcfg)(
        jparams, {"tokens": jnp.asarray(tokens)})
    grads, loss = make_grad_step(cfg)(_trainable(params_np),
                                      {"tokens": torch.from_numpy(tokens)})
    assert not loss.requires_grad
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5, abs=1e-6)
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(leaves(grads)) == len(jleaves)
    for g, jg in zip(leaves(grads), jleaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5,
                                   atol=1e-6)


def test_update_step_is_in_place_and_bit_equal_to_the_fused_step():
    _jcfg, cfg, _jparams, params_np, tokens = _inputs("llama3.2-1b")
    hp = AdamWConfig()
    batch = {"tokens": torch.from_numpy(tokens)}
    params = _trainable(params_np)
    opt = init_opt_state(params)
    before = [t.detach().clone() for t in leaves(params)]
    ptrs = [t.data_ptr() for t in leaves((params, opt))]
    grads, loss = make_grad_step(cfg)(params, batch)
    got_p, got_o = make_update_step(cfg, hp)(params, opt, grads)
    # the very tensors passed in, updated where they lie
    assert got_p is params and got_o is opt
    assert [t.data_ptr() for t in leaves((got_p, got_o))] == ptrs
    assert not all(torch.equal(a, b.detach())
                   for a, b in zip(before, leaves(params)))
    fused_p = _trainable(params_np)
    fused_o = init_opt_state(fused_p)
    fused_p, fused_o, fused_loss = make_train_step(cfg, hp)(fused_p, fused_o,
                                                            batch)
    assert torch.equal(loss, fused_loss)
    for a, b in zip(leaves((got_p, got_o)), leaves((fused_p, fused_o))):
        assert torch.equal(a.detach(), b.detach())


def test_trainer_runs_the_two_halves():
    cfg = smoke_variant(get_config("llama3.2-1b"))
    tr = Trainer(cfg, batch=BATCH, seq_len=SEQ, device="cpu")
    calls = []
    grad_step, update_step = tr.grad_step, tr.update_step

    def counted(name, fn):
        def call(*a):
            calls.append(name)
            return fn(*a)
        return call
    tr.grad_step = counted("grad", grad_step)
    tr.update_step = counted("update", update_step)
    recs = tr.run(2)
    assert calls == ["grad", "update"] * 2
    assert all(np.isfinite(r.loss) for r in recs) and tr.step == 2
