"""``remat``: each repeat of a layer group's pattern under activation
checkpointing (``torch.utils.checkpoint``, the reference's
``jax.checkpoint`` of its scan body).

For the llama3.2-1b smoke variant and one ``rec``, one ``rwkv``, one
``*_moe`` and one ``xattn`` pattern, in fp32: the port's gradients with
``remat`` on equal those with it off bit for bit (the recompute is the
same arithmetic), and both lie within the zoo tests' training tolerance
(``rtol=1e-5``, ``atol=1e-6``; rwkv6's ``atol`` 1e-4 of each leaf's
largest entry, as ``tests/test_torch_model_zoo_recurrent.py`` holds it)
of ``repro``'s ``jax.grad`` with ``remat`` on, from the same weights
carried across by ``repro_torch.convert``. Prefill and decode run
without grad, so ``remat`` leaves them as they were; the dry run's
traced FLOPs grow by exactly the forward of the layer groups.
"""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import model as JM  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.core.tree import flatten_with_path  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_abstract_mesh  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serving import engine as TE  # noqa: E402

from test_torch_model_zoo import (SEQ, _batches, _configs, _f32,  # noqa
                                  _params)

#: config -> its pattern (the smoke variant's first two block types) and
#: the share of a leaf's largest entry its gradients' ``atol`` takes
PATTERNS = {"llama3.2-1b": 0.0, "recurrentgemma-2b": 0.0,
            "rwkv6-7b": 1e-4, "dbrx-132b": 0.0, "musicgen-medium": 0.0}


@pytest.fixture
def deterministic():
    """PyTorch's deterministic kernels: the CPU's accumulating index put
    (the embedding's backward over repeated rows) adds in a thread-timed
    order otherwise, remat or not."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


def _port_grads(cfg, params, batch):
    flat, unflatten = flatten_with_path(params)
    leaves = [t.detach().clone().requires_grad_(True) for _p, t in flat]
    loss = TM.loss_fn(cfg, unflatten(leaves), batch)
    return loss.detach(), torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("name", sorted(PATTERNS))
def test_remat_gradients_bit_equal_and_match_reference(name, deterministic):
    jcfg, cfg = _configs(name, remat=True)
    assert jcfg.remat and cfg.remat
    jparams, params = _params(jcfg, 3)
    jbatch, batch = _batches(jcfg, cfg, SEQ, 8)
    on = _port_grads(cfg, params, batch)
    off = _port_grads(dataclasses.replace(cfg, remat=False), params, batch)
    assert torch.equal(on[0], off[0])
    assert all(torch.equal(a, b) for a, b in zip(on[1], off[1]))
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(jcfg, p, b)))(jparams, jbatch)
    assert float(on[0]) == pytest.approx(float(jloss), rel=1e-5, abs=1e-6)
    share = PATTERNS[name]
    for g, jg in zip(on[1], jax.tree_util.tree_leaves(jgrads)):
        want = _f32(jg)
        atol = share * np.abs(want).max() if share else 1e-6
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-5, atol=atol)


def test_remat_leaves_prefill_and_decode_as_they_were():
    _jcfg, cfg = _configs("recurrentgemma-2b", max_decode_len=2)
    _jp, params = _params(_jcfg, 5)
    tokens = torch.randint(0, cfg.vocab, (2, 20),
                           generator=torch.Generator().manual_seed(5),
                           dtype=torch.int32)
    outs = []
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        logits, caches = TE.make_prefill_step(c)(params,
                                                 {"tokens": tokens[:, :18]})
        step, _ = TE.make_decode_step(c)(params, tokens[:, 18:19], caches,
                                         18)
        outs.append((logits, step))
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_dry_run_counts_the_forward_recompute():
    """Traced FLOPs with ``remat`` less those without are the forward
    recompute: the layer groups' forward (the whole forward's less the
    logits' product; the lookup counts none), less the last product of
    the repeat, the FFN's down projection, whose output no backward
    reads: the non-reentrant checkpoint stops recomputing once every
    saved tensor is back."""
    from torch.utils.flop_counter import FlopCounterMode
    _jcfg, cfg = _configs("llama3.2-1b")
    mesh = make_abstract_mesh((1, 1), ("data", "model"))
    B, S = 2, 64
    shape = InputShape("t", S, B, "train")
    flops = {r: dryrun.dryrun_record(dataclasses.replace(cfg, remat=r),
                                     shape, mesh)["roofline"]
             ["traced_flops_global"] for r in (False, True)}
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.zeros((B, S), dtype=torch.int32)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        TM.forward(cfg, params, {"tokens": tokens})
    logits = 2 * B * S * cfg.d_model * cfg.vocab
    down = 2 * B * S * cfg.d_ff * cfg.d_model
    assert cfg.layer_groups == ((("full", "full"), 1),)
    assert flops[True] - flops[False] == fc.get_total_flops() - logits \
        - down > 0
