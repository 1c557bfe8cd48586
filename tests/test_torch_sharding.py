"""The port's sharded state held against the JAX package's.

``repro`` lays state out on a mesh of 8 forced CPU devices, which needs a
fresh interpreter (``conftest.run_in_subprocess``); one such run computes
everything the reference says here and prints it as JSON:

* ``param_pspecs`` / ``opt_pspecs`` of a 2-layer llama3.2-1b-shaped config
  (full widths) under ``2d`` and ``tp_zero1``, on a (data 2 x model 4)
  mesh; ``cache_pspecs`` and ``batch_pspecs`` of the smoke config;
* ``NamedSharding.devices_indices_map`` for specs that split one dim over
  two axes in either order, and leave dims whole;
* ``plan_shards`` of the smoke config's state laid out ``tp_zero1``:
  ``(tensor_name, rank, index, nbytes)`` of every record.

The port computes the same from :mod:`repro_torch.sharding` on
``device="cpu"`` and must agree entry for entry. Then the port's own
:class:`ShardedTensor` round trips, and refuses what JAX refuses.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import run_in_subprocess  # noqa: E402

from repro_torch.configs import get_config, smoke_variant, uniform_groups  # noqa: E402
from repro_torch.core.distributed import plan_shards  # noqa: E402
from repro_torch.core.tree import flatten_with_path, keystr  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, make_mesh  # noqa: E402
from repro_torch.models.model import param_shapes  # noqa: E402
from repro_torch.optim.adamw import init_opt_state  # noqa: E402
from repro_torch.serving.engine import cache_template  # noqa: E402
from repro_torch.sharding import (ShardedTensor, batch_pspecs,  # noqa: E402
                                  cache_pspecs, opt_pspecs, param_pspecs,
                                  shard_tree, spec_indices, unshard)

#: (shape, spec) pairs for the index maps
INDEX_CASES = [((8, 12), ("data", "model")), ((8, 12), (None, "model")),
               ((16, 4), (("data", "model"), None)),
               ((16, 4), (("model", "data"),)), ((6,), ()),
               ((4, 8, 8), (None, "model", "data"))]

REFERENCE = r"""
import dataclasses, json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
import repro.core as J
from repro.configs import get_config, smoke_variant
from repro.core.distributed import normalize_index
from repro.configs.base import uniform_groups
from repro.launch.mesh import make_mesh
from repro.models.model import init_params
from repro.optim.adamw import init_opt_state
from repro.serving.engine import cache_template
from repro.sharding.partition import (batch_pspecs, cache_pspecs,
                                      opt_pspecs, param_pspecs)

def enc(e):
    return list(e) if isinstance(e, tuple) else e

def specs(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {jax.tree_util.keystr(p): [enc(e) for e in s] for p, s in flat}

mesh = make_mesh((2, 4), ("data", "model"))
out = {"mesh": [[d.id for d in row] for row in mesh.devices]}
full = get_config("llama3.2-1b", n_layers=2,
                  layer_groups=uniform_groups("full", 2))
small = smoke_variant(get_config("llama3.2-1b"))
key = jax.random.PRNGKey(0)
for mode in ("2d", "tp_zero1"):
    cfg = dataclasses.replace(full, sharding_mode=mode)
    shapes = jax.eval_shape(lambda: init_params(cfg, key))
    out["params", mode] = specs(param_pspecs(cfg, shapes, mesh))
    out["opt", mode] = specs(opt_pspecs(cfg, shapes, mesh))
caches = cache_template(small, 4, 16)
for lc in (False, True):
    out["cache", lc] = specs(cache_pspecs(small, caches, mesh,
                                          long_context=lc))
for mode in ("2d", "fsdp"):
    cfg = dataclasses.replace(small, sharding_mode=mode)
    out["batch", mode] = specs(batch_pspecs(
        cfg, "train", {"tokens": jax.ShapeDtypeStruct((8, 16), jnp.int32),
                       "odd": jax.ShapeDtypeStruct((3, 5), jnp.int32)},
        mesh))
for shape, spec in CASES:
    imap = NamedSharding(mesh, P(*spec)).devices_indices_map(tuple(shape))
    out["index", str(shape), str(spec)] = {
        d.id: [list(r) for r in normalize_index(ix, shape)]
        for d, ix in imap.items()}
cfg = dataclasses.replace(small, sharding_mode="tp_zero1")
params = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                jax.eval_shape(lambda: init_params(cfg, key)))
state = {"model": params, "optimizer": init_opt_state(params)}
sp = {"model": param_pspecs(cfg, params, mesh),
      "optimizer": opt_pspecs(cfg, params, mesh)}
placed = jax.tree_util.tree_map(
    lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), state, sp,
    is_leaf=lambda x: isinstance(x, P))
recs, _ = J.plan_shards(placed, "state")
out["plan"] = sorted([r.tensor_name, r.rank, [list(i) for i in r.index],
                      r.nbytes] for r in recs)
print(json.dumps({str(k): v for k, v in out.items()}))
"""


@pytest.fixture(scope="module")
def ref():
    code = "CASES = %r\n" % (INDEX_CASES,) + REFERENCE
    return json.loads(run_in_subprocess(code, n_devices=8).splitlines()[-1])


def _enc(e):
    return list(e) if isinstance(e, tuple) else e


def _specs(tree, specs):
    """keystr path -> JSON spec, walking ``specs`` by ``tree``'s paths
    (specs are plain tuples)."""
    out = {}
    for p, _leaf in flatten_with_path(tree)[0]:
        node = specs
        for k in p:
            node = node[k]
        out[keystr(p)] = [_enc(e) for e in node]
    return out


def _mesh():
    return make_mesh((2, 4), ("data", "model"), "cpu")


def test_mesh_ids_match_reference(ref):
    assert _mesh().devices.tolist() == ref["mesh"]
    assert make_host_mesh(2, 4, device="cpu").shape == {"data": 2,
                                                       "model": 4}
    assert make_host_mesh(4, 4, n_devices=8, device="cpu").shape == \
        {"data": 4, "model": 2}


@pytest.mark.parametrize("mode", ["2d", "tp_zero1"])
def test_param_and_opt_specs_match_reference(ref, mode):
    cfg = get_config("llama3.2-1b", n_layers=2,
                     layer_groups=uniform_groups("full", 2),
                     sharding_mode=mode)
    shapes = param_shapes(cfg)
    mesh = _mesh()
    assert _specs(shapes, param_pspecs(cfg, shapes, mesh)) == \
        ref[str(("params", mode))]
    opt = {k: shapes for k in ("master", "m", "v")}
    got = _specs(opt, opt_pspecs(cfg, shapes, mesh))
    got["['count']"] = list(opt_pspecs(cfg, shapes, mesh)["count"])
    assert got == ref[str(("opt", mode))]


@pytest.mark.parametrize("long_context", [False, True])
def test_cache_specs_match_reference(ref, long_context):
    cfg = smoke_variant(get_config("llama3.2-1b"))
    caches = cache_template(cfg, 4, 16)
    assert _specs(caches, cache_pspecs(cfg, caches, _mesh(),
                                       long_context=long_context)) == \
        ref[str(("cache", long_context))]


@pytest.mark.parametrize("mode", ["2d", "fsdp"])
def test_batch_specs_match_reference(ref, mode):
    import dataclasses
    cfg = dataclasses.replace(smoke_variant(get_config("llama3.2-1b")),
                              sharding_mode=mode)
    batch = {"tokens": torch.empty(8, 16), "odd": torch.empty(3, 5)}
    got = {f"['{k}']": [_enc(e) for e in s]
           for k, s in batch_pspecs(cfg, "train", batch, _mesh()).items()}
    assert got == ref[str(("batch", mode))]


@pytest.mark.parametrize("shape,spec", INDEX_CASES)
def test_index_maps_match_reference(ref, shape, spec):
    from repro_torch.core.distributed import normalize_index
    got = {str(d): [list(r) for r in normalize_index(ix, shape)]
           for d, ix in spec_indices(shape, _mesh(), spec).items()}
    assert got == ref[str(("index", str(shape), str(spec)))]


def _smoke_state(mode="tp_zero1"):
    import dataclasses
    cfg = dataclasses.replace(smoke_variant(get_config("llama3.2-1b")),
                              sharding_mode=mode)
    from repro_torch.core import dtypes
    params = [torch.zeros(s.shape, dtype=dtypes.lookup(s.dtype).torch)
              for _p, s in flatten_with_path(param_shapes(cfg))[0]]
    params = flatten_with_path(param_shapes(cfg))[1](params)
    return cfg, {"model": params, "optimizer": init_opt_state(params)}


def _state_specs(cfg, state, mesh):
    return {"model": param_pspecs(cfg, state["model"], mesh),
            "optimizer": opt_pspecs(cfg, state["model"], mesh)}


def test_plan_shards_matches_reference(ref):
    """Replicas deduplicated, writers balanced, rank = virtual device id:
    the same records as ``repro.core.plan_shards`` of the same layout."""
    cfg, state = _smoke_state()
    mesh = _mesh()
    placed = shard_tree(state, _state_specs(cfg, state, mesh), mesh)
    recs, objs = plan_shards(placed, "state")
    got = sorted([r.tensor_name, r.rank, [list(i) for i in r.index],
                  r.nbytes] for r in recs)
    assert got == ref["plan"]
    assert objs == {}
    # each unique region written once: the records tile every leaf
    total = sum(t.numel() * t.element_size()
                for _p, t in flatten_with_path(state)[0])
    assert sum(r.nbytes for r in recs) == total


def test_shard_tree_round_trips_and_shares_replicas():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(16, 12, generator=gen)
    b = torch.randn(12, generator=gen).to(torch.bfloat16)
    mesh = _mesh()
    tree = {"x": x, "b": b, "c": torch.tensor(3, dtype=torch.int32),
            "meta": {"note": "kept"}}
    st = shard_tree(tree, {"x": (("model", "data"), None), "b": ("model",),
                           "c": ()}, mesh)
    assert isinstance(st["x"], ShardedTensor)
    assert st["meta"] == {"note": "kept"}
    # 8 unique regions of x, 4 of b (replicated over data), 1 of c
    assert len(list(st["x"].unique_shards())) == 8
    assert len(list(st["b"].unique_shards())) == 4
    by_dev = {s.device: s.data for s in st["b"].addressable_shards}
    assert by_dev[0] is by_dev[4]  # replicas share one tensor
    assert all(s.data.is_contiguous() for s in st["x"].addressable_shards)
    back = unshard(st)
    for k in ("x", "b", "c"):
        assert torch.equal(back[k], tree[k]) and back[k].dtype == tree[k].dtype
    # shards are copies: updating the source leaves them alone
    x.add_(1)
    assert not torch.equal(unshard(st["x"]), x)


def test_sharded_tensor_refuses_what_jax_refuses():
    mesh = _mesh()
    with pytest.raises(ValueError, match="does not split"):
        spec_indices((6, 4), mesh, ("model", None))
    with pytest.raises(ValueError, match="no mesh axis"):
        spec_indices((8,), mesh, ("pod",))
    with pytest.raises(ValueError, match="no tensor for region"):
        ShardedTensor((8,), torch.float32, mesh, ("model",), {})
    with pytest.raises(ValueError, match="contiguous"):
        ShardedTensor((8,), torch.float32, mesh, (),
                      {((0, 8),): torch.zeros(8, dtype=torch.float64)})


def test_make_mesh_needs_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="is_available"):
        make_mesh((2, 4), ("data", "model"))
    with pytest.raises(ValueError, match="axis names"):
        make_mesh((2, 4), ("data",), "cpu")


@pytest.mark.gpu
def test_shard_tree_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    mesh = make_mesh((2, 4), ("data", "model"))
    x = torch.arange(64.0, device="cuda").reshape(8, 8)
    st = shard_tree({"x": x}, {"x": ("data", "model")}, mesh)
    assert all(s.data.is_cuda for s in st["x"].addressable_shards)
    assert torch.equal(unshard(st)["x"], x)


def test_elastic_reads_coalesce_runs_bit_for_bit(tmp_path):
    """A shard's rows cut by another layout's columns are read as spans
    and copied out (strided, or run by run when the runs differ): the
    same bytes as one read a run, in fewer reads."""
    from repro_torch.core.restore import (COALESCE_GAP_BYTES, _read_span,
                                          _spans)
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, 2 << 20, dtype=np.uint8)
    path = str(tmp_path / "f")
    data.tofile(path)
    cases = {
        # equal runs at equal strides: rows of a column cut
        "strided": [(path, 64 + 4096 * i, 2048, 2048 * i) for i in range(200)],
        # ragged runs and gaps, one gap past the coalescing distance
        "ragged": [(path, 10, 7, 0), (path, 40, 100, 7), (path, 5000, 3, 107),
                   (path, 5000 + COALESCE_GAP_BYTES + 1, 9, 110),
                   (path, 1_900_000, 1, 119)],
    }
    fd = os.open(path, os.O_RDONLY)
    try:
        for name, reads in cases.items():
            want = np.concatenate([data[o:o + n] for _p, o, n, _d in reads])
            out = np.zeros(len(want), np.uint8)
            groups = _spans(reads, cap=1 << 20)
            # each group counts the bytes it asked for, not its gaps
            assert sum(_read_span(fd, g, out) for g in groups) == len(want)
            assert np.array_equal(out, want), name
            assert len(groups) < len(reads), name
        # a group never spans more than the cap
        assert len(_spans(cases["strided"], cap=8192)) == 100
    finally:
        os.close(fd)
