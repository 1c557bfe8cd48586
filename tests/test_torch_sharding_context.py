"""The port's ambient-mesh sharding context against ``repro``'s.

``repro_torch.sharding.context._resolve`` maps a spec's logical axes onto a
mesh exactly as ``repro.sharding.context._resolve`` does: held case for
case over the specs the model constrains with and a few edge cases, on a
two-axis ``(data, model)`` and a three-axis ``(pod, data, model)`` mesh,
with the ``seq`` axis unmapped or mapped to ``data``, and with the batch
axes unset or expanded to ``(data, model)`` (fsdp). ``_resolve`` reads only
the mesh's ``axis_names``, so both get the same stand-in. Also: with no
mesh ``constrain`` is the identity, ``activate`` nests and restores, a
dimension its resolved axes do not divide stays whole, and
``placements_for`` lays a resolved spec out as ``DTensor`` placements
(a tuple of axes out of the mesh's order raises) that ``spec_of`` reads
back.
"""

import itertools
import types

import pytest

torch = pytest.importorskip("torch")

from jax.sharding import PartitionSpec as P
from repro.sharding import context as jctx
from repro_torch.sharding import context as tctx
from repro_torch.sharding.partition import placements_for, spec_of

BATCH = ("pod", "data")
SPECS = [
    (BATCH, None, None),                 # embeddings, groups, loss
    (BATCH, "model", None, None),        # Ulysses q/k/v, seq-sharded cache
    (BATCH, "model", None),              # Ulysses out, SP residual
    (BATCH, None, "model"),              # FFN hidden
    (None, "seq", None, None),           # context-parallel decode cache
    (BATCH, None, None, None),           # decode cache
    ("model", BATCH, None, None),        # MoE expert in/out
    (BATCH, None, "model", None),        # attention on local shards
    (None, None),                        # nothing
    ("model", "model"),                  # one axis used twice
    (("data", "model"), None),           # fsdp params
    ("seq", "data"),                     # seq and data on one axis
    ("absent", None),                    # an axis no mesh has
]
MESHES = {"2axis": ("data", "model"), "3axis": ("pod", "data", "model")}


def _as_tuple(p):
    return None if p is None else tuple(p)


@pytest.fixture
def fresh_state():
    yield
    for mod in (jctx, tctx):
        mod.set_seq_axis(None)
        mod.set_batch_axes(None)


@pytest.mark.parametrize("spec,mesh,seq,batch", list(itertools.product(
    SPECS, sorted(MESHES), (None, "data"), (None, ("data", "model")))))
def test_resolve_matches_reference(fresh_state, spec, mesh, seq, batch):
    stand_in = types.SimpleNamespace(axis_names=MESHES[mesh])
    for mod in (jctx, tctx):
        mod.set_seq_axis(seq)
        mod.set_batch_axes(batch)
    want = _as_tuple(jctx._resolve(P(*spec), stand_in))
    assert tctx._resolve(spec, stand_in) == want
    assert tctx.seq_axis_active() == jctx.seq_axis_active() \
        == (seq is not None)


def test_constrain_is_identity_without_a_mesh():
    x = torch.arange(6.0).reshape(2, 3)
    assert tctx.active_mesh() is None
    assert tctx.constrain(x, (BATCH, None)) is x


def test_activate_nests_and_restores():
    a = types.SimpleNamespace(axis_names=("data",), mesh_dim_names=None)
    b = types.SimpleNamespace(axis_names=("model",), mesh_dim_names=None)
    assert tctx.active_mesh() is None
    with tctx.activate(a):
        assert tctx.active_mesh() is a
        with tctx.activate(b):
            assert tctx.active_mesh() is b
            with tctx.activate(None):
                assert tctx.active_mesh() is None
            assert tctx.active_mesh() is b
        assert tctx.active_mesh() is a
    assert tctx.active_mesh() is None
    with pytest.raises(RuntimeError), tctx.activate(a):
        raise RuntimeError("unwinds")
    assert tctx.active_mesh() is None


@pytest.mark.parametrize("spec,mesh", [
    ((("data", "model"), None), "2axis"),
    (("model", "data"), "2axis"),
    ((None, "model", None), "3axis"),
    ((("pod", "data"), None, "model"), "3axis"),
    ((None,), "2axis"),
])
def test_placements_round_trip(spec, mesh):
    from torch.distributed.tensor import Replicate, Shard
    stand_in = types.SimpleNamespace(axis_names=MESHES[mesh])
    pl = placements_for(spec, stand_in)
    assert len(pl) == len(MESHES[mesh])
    for name, p in zip(MESHES[mesh], pl):
        dims = [i for i, e in enumerate(spec) if e is not None
                and name in (e if isinstance(e, tuple) else (e,))]
        assert p == (Shard(dims[0]) if dims else Replicate())
    assert spec_of(pl, stand_in, len(spec)) == tuple(spec)


def test_placements_refuse_what_a_dtensor_cannot_lay_out():
    stand_in = types.SimpleNamespace(axis_names=MESHES["2axis"])
    with pytest.raises(ValueError, match="mesh's order"):
        placements_for((("model", "data"),), stand_in)
    with pytest.raises(ValueError, match="no mesh axis"):
        placements_for(("pod",), stand_in)
    with pytest.raises(ValueError, match="used twice"):
        placements_for(("model", "model"), stand_in)


@pytest.mark.parametrize("spec,shape,want", [
    (("data", None), (4, 6), ("data", None)),
    (("data", None), (1, 6), (None, None)),          # batch 1 stays whole
    ((("data", "model"), None), (2, 6), (None, None)),
    ((("data", "model"), None), (8, 6), (("data", "model"), None)),
    ((None, "model"), (3, 6), (None, "model")),
    ((None, "model"), (3, 5), (None, None)),
])
def test_constrain_leaves_uneven_dimensions_whole(spec, shape, want):
    stand_in = types.SimpleNamespace(axis_names=MESHES["2axis"],
                                     mesh=torch.zeros(2, 2))
    assert tctx._divisible(spec, shape, stand_in) == want
