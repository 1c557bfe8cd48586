"""The port's mixture of experts and its two configs held against the JAX
package.

The same numpy inputs, and the same JAX-initialised parameters carried
over by ``repro_torch.convert``, go through ``repro`` and ``repro_torch``
with ``device="cpu"``:

* ``route``: the dispatch and combine tensors equal the reference's (they
  are one-hots and gate values: dispatch exactly, combine within
  ``rtol=1e-6``), the aux loss within ``1e-6``, at top 1, 2 and 4, with
  capacity overflow, and with tied router probabilities (a tie routes to
  the lower expert, as ``jax.lax.top_k`` breaks it); ``apply_moe`` with
  and without the shared expert, fp32 within ``rtol=1e-5, atol=1e-6``.
* dbrx-132b and llama4-maverick-400b-a17b at ``smoke_variant``: the
  parameter tree, the fields, fp32 forward logits, the loss with the aux
  term and every gradient leaf, prefill then decode against the
  reference's caches and logits, and greedy tokens
  (``tests/test_torch_model_zoo_recurrent.py``'s checks and tolerances).
* The partition rules give every leaf of the full-size trees the
  reference's spec, the expert-stacked ``(E, d, f)`` matrices expert
  parallel over ``model``.
* llama4's ``chunked`` decode ring without the MoE (layers ``chunked``,
  ``full``): prefill then decode across the 16-token chunk's restart,
  against the reference's caches and logits and the port's forward
  (fp32); and ``chip_smoke.py``'s phase 12d checks at smoke size, the
  port alone in bf16: the chunk ring's decode against a forward within
  a relative L2 error of 2e-2 across the restart (a ring decoded as a
  window of the chunk's size reads past it), and the dispatch check of
  a MoE layer's recorded call on a case that drops tokens.
"""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_variant as jsmoke  # noqa: E402
from repro.models import moe as JMoE  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core.tree import flatten_with_path  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import layers, moe  # noqa: E402

from test_torch_model_zoo_recurrent import (  # noqa: E402
    check_decode, check_forward_loss_and_grads, check_greedy,
    check_tree_and_fields)

MOE = ["dbrx-132b", "llama4-maverick-400b-a17b"]


def _moe_cfg(**kw):
    """(reference, port) configs: dbrx's smoke variant in fp32 with
    ``kw``."""
    jcfg = dataclasses.replace(jsmoke(jget_config("dbrx-132b")),
                               dtype="float32", **kw)
    return jcfg, ModelConfig(**{f.name: getattr(jcfg, f.name)
                                for f in dataclasses.fields(ModelConfig)})


def _params(cfg, seed: int):
    jp = JMoE.init_moe(cfg, jax.random.PRNGKey(seed))
    tp = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.asarray(a).copy()), jp)
    return jp, tp


@pytest.mark.parametrize("top_k,capacity_factor", [(1, 1.25), (2, 1.25),
                                                   (4, 1.25), (2, 0.5)])
def test_route_matches_reference(top_k, capacity_factor):
    """Dispatch (one-hots) equal, combine (gate values) within 1e-6, aux
    within 1e-6; ``capacity_factor`` 0.5 drops tokens past capacity."""
    jcfg, cfg = _moe_cfg(top_k=top_k, capacity_factor=capacity_factor)
    jp, p = _params(jcfg, 0)
    x = np.random.default_rng(1).standard_normal((3, 16, jcfg.d_model)) \
        .astype(np.float32)
    jd, jc, jaux = JMoE.route(jcfg, jp, jnp.asarray(x))
    d, c, aux = moe.route(cfg, p, torch.from_numpy(x))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=1e-7)
    assert float(aux) == pytest.approx(float(jaux), abs=1e-6)
    if capacity_factor < 1:  # some (token, k) pairs found their expert full
        assert float(d.sum()) < 3 * 16 * top_k


def test_route_breaks_ties_toward_the_lower_expert():
    """A router of zeros gives every token equal probabilities: the top k
    are experts 0 .. k-1 in both packages, each filled to its capacity."""
    jcfg, cfg = _moe_cfg(top_k=2)
    jp, p = _params(jcfg, 2)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    p = dict(p, router=torch.zeros_like(p["router"]))
    x = np.random.default_rng(3).standard_normal((1, 8, jcfg.d_model)) \
        .astype(np.float32)
    jd, _jc, _a = JMoE.route(jcfg, jp, jnp.asarray(x))
    d, _c, _a = moe.route(cfg, p, torch.from_numpy(x))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    C = float(moe.capacity(cfg, 8))
    assert C < 8 and d.sum((0, 1, 3)).tolist() == [C, C, 0.0, 0.0]


@pytest.mark.parametrize("shared,act", [(False, "silu"), (True, "silu"),
                                        (False, "gelu")])
def test_apply_moe_matches_reference(shared, act):
    jcfg, cfg = _moe_cfg(shared_expert=shared, act=act)
    jp, p = _params(jcfg, 4)
    x = np.random.default_rng(5).standard_normal((2, 24, jcfg.d_model)) \
        .astype(np.float32)
    want, jaux = JMoE.apply_moe(jcfg, jp, jnp.asarray(x))
    got, aux = moe.apply_moe(cfg, p, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    assert aux.dtype == torch.float32
    assert float(aux) == pytest.approx(float(jaux), abs=1e-6)
    assert moe.capacity(cfg, 16) == JMoE.capacity(jcfg, 16)


@pytest.mark.parametrize("name", MOE)
def test_param_tree_and_fields_match_reference(name):
    check_tree_and_fields(name)


@pytest.mark.parametrize("name", MOE)
def test_float32_forward_loss_and_grads_match_reference(name):
    """The loss carries ``router_aux_coef`` times the summed aux."""
    check_forward_loss_and_grads(name, seed=21)


@pytest.mark.parametrize("name", MOE)
def test_prefill_then_decode_matches_reference(name):
    """llama4: chunked attention (a 16-token chunk ring that restarts at
    32) beside full, MoE and dense FFNs, the shared expert."""
    check_decode(name, prompt=20, n_new=12, seed=22, against_forward=False)


@pytest.mark.parametrize("name", MOE)
def test_greedy_tokens_equal_reference(name):
    check_greedy(name, seed=23)


@pytest.mark.parametrize("name", MOE)
def test_partition_rules_give_the_reference_specs(name):
    from repro.sharding import partition as jpart
    from repro_torch.sharding import partition as tpart
    cfg = get_config(name)
    seen = 0
    for path, spec in flatten_with_path(TM.param_shapes(cfg))[0]:
        names = tuple(str(p) for p in path)
        base = spec.shape[1:] if "groups" in names else spec.shape
        for mode in ("2d", "tp_zero1"):
            got = tpart._spec_for(names, base, mode)
            assert got == jpart._spec_for(names, base, mode), (names, mode)
            if "moe" in names and "shared" not in names \
                    and names[-1] in ("w_gate", "w_up", "w_down"):
                assert got[0] == "model" and len(base) == 3, names
                seen += 1
    assert seen == 2 * 3 * sum(1 for p, _n in cfg.layer_groups for b in p
                               if b.endswith("_moe"))


# ------------------------------------------- llama4's chunk ring (12d)
LLAMA4 = "llama4-maverick-400b-a17b"


@pytest.mark.parametrize("prompt,n_new", [(20, 12), (24, 12)])
def test_chunk_ring_decode_matches_reference_and_forward(prompt, n_new):
    """llama4's smoke variant with its MoE layer made ``full``: no
    capacity, so each decode step's logits also equal the port's forward
    at that position. A 20-token prompt leaves a 4-token partial chunk in
    the ring (the restart at 16 inside the prefill); a 24-token one
    decodes across the restart at 32."""
    check_decode(LLAMA4, prompt=prompt, n_new=n_new, seed=24,
                 against_forward=True,
                 layer_groups=((("chunked", "full"), 1),), n_layers=2)


@pytest.fixture(scope="module")
def smoke():
    """``chip_smoke.py`` (the repo root's card smoke run), whose phase 12d
    checks run here on the CPU."""
    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _llama4_bf16(pattern):
    cfg = smoke_variant(get_config(LLAMA4))
    assert cfg.dtype == "bfloat16" and cfg.chunk == 16
    return dataclasses.replace(cfg, layer_groups=((pattern, 1),),
                               n_layers=len(pattern))


def test_chunk_ring_restart_within_the_smoke_bound(smoke):
    """12d's gate at smoke size: one ``chunked`` layer, a prefill of 16
    tokens and 32 decode steps fed the next given tokens; the logits at
    31, 32 (the restart) and 47 within ``RING_REL_L2`` of the forward's.
    The control decodes the same caches as a window of the chunk's size,
    which keeps the last chunk's keys: at 32 and 33 it reads past the
    bound (at 47 both see positions 32-47)."""
    cfg = _llama4_bf16(("chunked",))
    errs = smoke.chunk_ring_errs("cpu", cfg, 2, 16, 32)
    held = smoke.ring_positions(cfg, 16, 32)
    assert held == (31, 32, 47)
    assert all(errs[p] < smoke.RING_REL_L2 for p in held), errs
    window = dataclasses.replace(cfg, layer_groups=((("window",), 1),),
                                 window=cfg.chunk)
    control = smoke.chunk_ring_errs("cpu", cfg, 2, 16, 32, window)
    assert control[31] < smoke.RING_REL_L2, control
    assert all(control[p] > smoke.RING_REL_L2 for p in (32, 33)), control
    assert control[47] < smoke.RING_REL_L2, control


def test_dispatch_check_of_a_recorded_moe_layer(smoke):
    """12d's dispatch check at smoke size (4 experts, top 1, groups of
    16, capacity 5) on a prefill that drops tokens: no problem found, and
    dropped tokens among those checked. With the shared expert taken out
    of the layer's output the check reports the tokens."""
    cfg = _llama4_bf16(("chunked", "chunked_moe"))
    params = TM.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab, (2, 40), dtype=np.int32))
    seen = []
    with torch.no_grad(), smoke._recording_moe(seen):
        TM.forward(cfg, params, {"tokens": tokens})
    assert len(seen) == 1
    got = smoke.dispatch_check(cfg, seen[0])
    assert got["problems"] == [], got
    assert got["capacity"] == 5 and got["groups"] == 5
    assert got["dropped"] > 0 and got["checked_dropped"] > 0, got
    assert got["kept_rel_l2_max"] < smoke.DISPATCH_REL_L2
    rec = dict(seen[0])
    with torch.no_grad():
        rec["out"] = rec["out"] - layers.apply_ffn(cfg, rec["p"]["shared"],
                                                   rec["x"])
    bad = smoke.dispatch_check(cfg, rec)
    assert len(bad["problems"]) == 2, bad
