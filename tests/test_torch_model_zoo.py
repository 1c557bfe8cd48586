"""The port's attention-family model zoo held against the JAX package:
parameter trees, configs, forward, loss and gradients.

For each of the five configs the port carries beside llama3.2-1b
(llama2-7b, starcoder2-7b, gemma3-27b, command-r-35b, musicgen-medium) at
its ``smoke_variant``, and a ``chunked`` override of gemma3's, the same
JAX-initialised parameters (carried over by ``repro_torch.convert``) and
the same batch (both packages' pipelines draw it from one numpy seed:
codebook tokens and conditioning memory included) go through ``repro``
and ``repro_torch`` with ``device="cpu"``:

* the parameter tree equals ``jax.eval_shape(init_params)`` leaf for
  leaf (paths, shapes, dtypes), and every field the two ``ModelConfig``
  share is equal; the configs of slice 14 (held in their own files) pass
  ``check_supported`` at full size;
* forward logits, loss and every gradient leaf, fp32 within ``rtol=1e-5,
  atol=1e-6`` (``tests/test_torch_model.py``'s: same algorithm and cast
  points, XLA and ATen sum in other orders; logits ``atol=1e-5``).

Decode, generation, bf16 and the layers on their own are in
``tests/test_torch_model_zoo_serving.py``; the helpers here serve both.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")


from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.core.distributed import _path_str
from repro.data.pipeline import SyntheticTokenPipeline as JPipeline
from repro.models import model as JM
from repro_torch.configs import get_config, list_configs, smoke_variant
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import from_numpy_state
from repro_torch.core.tree import flatten_with_path, path_str
from repro_torch.data.pipeline import SyntheticTokenPipeline
from repro_torch.models import model as TM

ZOO = ["llama2-7b", "starcoder2-7b", "gemma3-27b", "command-r-35b",
       "musicgen-medium"]
#: the configs of slice 14 and a module path their trees hold
UNPORTED = {"dbrx-132b": "/moe/", "llama4-maverick-400b-a17b": "/shared/",
            "recurrentgemma-2b": "/rec/", "rwkv6-7b": "/tmix/",
            "paligemma-3b": "/attn/"}
#: gemma3's smoke variant with its window block made chunked
CHUNKED = {"layer_groups": ((("chunked", "full"), 1),), "chunk": 16}
BATCH, SEQ = 2, 32


def _configs(name: str, dtype: str = "float32", **kw):
    jcfg = dataclasses.replace(jsmoke(jget_config(name)), dtype=dtype, **kw)
    cfg = dataclasses.replace(smoke_variant(get_config(name)), dtype=dtype,
                              **kw)
    return jcfg, cfg


def _params(jcfg, seed: int):
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    return jparams, from_numpy_state(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu")


def _batches(jcfg, cfg, seq: int, seed: int):
    """(jax batch, torch batch) of one step, drawn by both pipelines."""
    jb = JPipeline(jcfg, BATCH, seq, seed=seed).next_batch()
    tb = SyntheticTokenPipeline(cfg, BATCH, seq, seed=seed).next_batch()
    assert sorted(jb) == sorted(tb)
    for key in jb:
        np.testing.assert_array_equal(jb[key], tb[key])
    return ({k: jnp.asarray(v) for k, v in jb.items()},
            {k: torch.from_numpy(v) for k, v in tb.items()})


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("name", ZOO)
def test_param_tree_and_fields_match_reference(name):
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


@pytest.mark.parametrize("name", sorted(UNPORTED))
def test_unported_configs_are_refused(name):
    """The configs an earlier slice refused (MoE, RG-LRU, RWKV6, the
    prefix-LM) are ported now (``tests/test_torch_moe.py``,
    ``test_torch_model_zoo_recurrent.py``, ``test_torch_prefix_lm.py``):
    the full-size config built from the reference's fields passes
    ``check_supported`` and its tree has the smoke variant's paths, with
    the block type's modules; only a block type the reference does not
    run either is refused."""
    jcfg = jget_config(name)
    cfg = ModelConfig(**{f.name: getattr(jcfg, f.name)
                         for f in dataclasses.fields(ModelConfig)})
    TM.check_supported(cfg)

    def leaf_names(c):  # paths with the group and position cut off
        return {"/".join(path_str(p).split("/")[3:]) or path_str(p)
                for p, _s in flatten_with_path(TM.param_shapes(c))[0]}
    paths = [path_str(p) for p, _s in flatten_with_path(
        TM.param_shapes(cfg))[0]]
    assert leaf_names(cfg) == leaf_names(smoke_variant(cfg))
    assert any(UNPORTED[name] in p for p in paths)
    bad = dataclasses.replace(cfg, layer_groups=((("mamba",), 1),))
    with pytest.raises(ValueError, match="mamba"):
        TM.param_shapes(bad)


def _loss_and_grads(jcfg, cfg, seed: int):
    """(JAX logits, loss, grad leaves; the port's logits, loss, grads
    with paths) of one batch."""
    jparams, params = _params(jcfg, seed)
    flat, unflatten = flatten_with_path(params)
    params = unflatten([t.requires_grad_(True) for _p, t in flat])
    jbatch, batch = _batches(jcfg, cfg, SEQ, seed + 5)

    def jloss_fn(p, b):
        return JM.loss_fn(jcfg, p, b), JM.forward(jcfg, p, b)[0]
    (jloss, jlogits), jgrads = jax.jit(jax.value_and_grad(
        jloss_fn, has_aux=True))(jparams, jbatch)
    with torch.no_grad():
        logits = TM.forward(cfg, params, batch)
    loss = TM.loss_fn(cfg, params, batch)
    grads = torch.autograd.grad(loss, [t for _p, t in flat])
    return (jlogits, float(jloss), jax.tree_util.tree_leaves(jgrads),
            logits, float(loss.detach()),
            [(path_str(p), g) for (p, _t), g in zip(flat, grads)])


@pytest.mark.parametrize("name,kw", [(n, {}) for n in ZOO]
                         + [("gemma3-27b", CHUNKED)],
                         ids=ZOO + ["gemma3-27b-chunked"])
def test_float32_forward_loss_and_grads_match_reference(name, kw):
    jcfg, cfg = _configs(name, **kw)
    jlogits, jloss, jgrads, logits, loss, grads = _loss_and_grads(
        jcfg, cfg, seed=3)
    assert tuple(logits.shape) == jlogits.shape
    np.testing.assert_allclose(_f32(logits), _f32(jlogits), rtol=1e-5,
                               atol=1e-5)
    assert loss == pytest.approx(jloss, rel=1e-5, abs=1e-6)
    assert len(grads) == len(jgrads)
    for (path, g), jg in zip(grads, jgrads):
        np.testing.assert_allclose(g.numpy(), _f32(jg), rtol=1e-5,
                                   atol=1e-6, err_msg=path)




@pytest.mark.parametrize("name", ZOO)
def test_partition_rules_give_the_reference_specs(name):
    """Every leaf of the full-size tree, in both sharding modes, gets the
    reference rules' spec: biases and norms replicated, the ``xattn``
    projections sharded as the self-attention's, the codebook embedding
    and head as the plain ones."""
    from repro.sharding import partition as jpart
    from repro_torch.sharding import partition as tpart
    cfg = get_config(name)
    for path, spec in flatten_with_path(TM.param_shapes(cfg))[0]:
        names = tuple(str(p) for p in path)
        base = spec.shape[1:] if "groups" in names else spec.shape
        for mode in ("2d", "tp_zero1"):
            got = tpart._spec_for(names, base, mode)
            assert got == jpart._spec_for(names, base, mode), (names, mode)
            if names[-1].startswith("b") or names[-2].startswith("ln"):
                assert got == (None,) * len(base), names
            if names[-2] == "xattn":
                assert got == tpart._spec_for(
                    names[:-2] + ("attn", names[-1]), base, mode)
