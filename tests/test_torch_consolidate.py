"""Offline shard consolidation in the port, held against the JAX
package's: the reference's two cases (one file; 8 shards into 2
aggregates, restored onto the same and another layout), steps that cross
both ways (a port-written step the port consolidated restores through
``repro``, and a ``repro``-consolidated step through the port), and the
limits both share: an int8q tensor is decoded into raw fp32, a delta step
is refused, and ``verify`` fails a consolidated step whose manifest
still names the rank files (``ROADMAP.md`` Queue 3).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import run_in_subprocess  # noqa: E402

import repro.core as J  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.core.consolidate import consolidate_step_dir as ref_consolidate  # noqa: E402
from repro_torch.convert import from_numpy_state  # noqa: E402
from repro_torch.core.consolidate import (consolidate_step_dir,  # noqa: E402
                                          file_count)
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.sharding import shard_tree, unshard  # noqa: E402
from repro_torch.storage import cli as port_cli  # noqa: E402

W = np.arange(8 * 16, dtype=np.float32).reshape(8, 16)
NOTE = "consolidate me"

REFERENCE = r"""
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.core import CheckpointManager, step_dir
from repro.core.consolidate import consolidate_step_dir, file_count
from repro.launch.mesh import make_mesh
port_dir, repro_dir = sys.argv[1], sys.argv[2]
mesh = make_mesh((8,), ("data",))
w = np.arange(8 * 16, dtype=np.float32).reshape(8, 16)
# the port's consolidated step, through repro: same and another layout
mgr = CheckpointManager(port_dir, mode="datastates")
for spec in (P("data", None), P(None, "data")):
    tpl = {"w": jax.ShapeDtypeStruct((8, 16), jnp.float32,
                                     sharding=NamedSharding(mesh, spec)),
           "meta": {"step": 0, "note": ""}}
    r = mgr.restore(tpl, step=2)
    assert np.array_equal(np.asarray(r["w"]), w), spec
    assert r["meta"]["note"] == "consolidate me"
mgr.close()
# repro writes 8 shards and consolidates them for the port to read
state = {"w": jax.device_put(jnp.asarray(w), NamedSharding(mesh, P("data", None))),
         "meta": {"step": 2, "note": "consolidate me"}}
mgr = CheckpointManager(repro_dir, mode="datastates")
mgr.save(2, state, blocking=True)
mgr.close()
sdir = step_dir(repro_dir, 2)
assert file_count(sdir) == 8
assert len(consolidate_step_dir(sdir, group=4)) == 2 and file_count(sdir) == 2
print("REFERENCE OK")
"""


def _sharded(mesh, spec, w=W):
    return shard_tree({"w": torch.from_numpy(w.copy())}, {"w": spec},
                      mesh)["w"]


def _manager(root):
    return T.CheckpointManager.from_policy(
        str(root), T.CheckpointPolicy(
            engine=T.EnginePolicy(host_cache_bytes=16 << 20)), device="cpu")


def test_consolidate_singlefile_noop_safe(tmp_path):
    state = {"a": torch.arange(100, dtype=torch.float32), "meta": {"step": 1}}
    mgr = _manager(tmp_path)
    try:
        mgr.save(1, state, blocking=True)
        sdir = T.step_dir(str(tmp_path), 1)
        assert file_count(sdir) == 1
        written = consolidate_step_dir(sdir, group=8, device="cpu")
        assert len(written) == 1 and file_count(sdir) == 1
        assert os.path.basename(written[0]) == "agg00000.dsllm"
        out = mgr.restore(state, step=1)
        assert torch.equal(out["a"], state["a"])
        assert out["meta"] == state["meta"]
    finally:
        mgr.close()


def test_consolidate_sharded_many_ranks_and_across_packages(tmp_path):
    """8 shards -> 2 aggregates; the port restores them onto the same and
    another layout, ``repro`` restores them too (a subprocess with 8
    devices), and a step ``repro`` consolidated restores through the
    port."""
    port_dir, repro_dir = tmp_path / "port", tmp_path / "repro"
    mesh = make_mesh((8,), ("data",), "cpu")
    state = {"w": _sharded(mesh, ("data", None)),
             "meta": {"step": 2, "note": NOTE}}
    mgr = _manager(port_dir)
    try:
        mgr.save(2, state, blocking=True)
        sdir = T.step_dir(str(port_dir), 2)
        assert file_count(sdir) == 8  # one per owning device
        written = consolidate_step_dir(sdir, group=4, device="cpu")
        assert len(written) == 2 and file_count(sdir) == 2
        assert sorted(os.listdir(sdir)) == ["agg00000.dsllm",
                                            "agg00001.dsllm"]
        r = mgr.restore(state, step=2)
        assert np.array_equal(unshard(r["w"]).numpy(), W)
        assert r["meta"]["note"] == NOTE
        tpl = {"w": _sharded(mesh, (None, "data"), np.zeros_like(W)),
               "meta": {}}
        r2 = mgr.restore(tpl, step=2)
        assert r2["w"].spec == (None, "data")
        assert np.array_equal(unshard(r2["w"]).numpy(), W)
    finally:
        mgr.close()
    out = run_in_subprocess(
        "import sys\nsys.argv = [''] + %r\n"
        % [str(port_dir), str(repro_dir)] + REFERENCE, n_devices=8)
    assert "REFERENCE OK" in out
    mgr = T.CheckpointManager.from_policy(str(repro_dir), device="cpu")
    try:
        for spec in (("data", None), (None, "data")):
            tpl = {"w": _sharded(mesh, spec, np.zeros_like(W)),
                   "meta": {"step": 0, "note": ""}}
            r = mgr.restore(tpl, step=2)
            assert np.array_equal(unshard(r["w"]).numpy(), W)
            assert r["meta"]["note"] == NOTE
    finally:
        mgr.close()


def test_consolidated_step_fails_verify_in_both_packages(tmp_path, capsys):
    """Consolidation leaves the ``StepManifest``'s per-file checksums
    naming the rank files it removed: both packages' ``verify`` report
    the step corrupt and exit 1, while restore (which reads whatever
    ``.dsllm`` files the step holds) still works (Queue 3, shared)."""
    from repro.storage import cli as ref_cli
    mesh = make_mesh((2,), ("data",), "cpu")
    state = {"w": _sharded(mesh, ("data", None)), "meta": {"step": 1}}
    mgr = _manager(tmp_path)
    try:
        mgr.save(1, state, blocking=True)
    finally:
        mgr.close()
    assert port_cli.main(["--root", str(tmp_path), "--device", "cpu",
                          "verify"]) == 0
    consolidate_step_dir(T.step_dir(str(tmp_path), 1), device="cpu")
    capsys.readouterr()
    assert port_cli.main(["--root", str(tmp_path), "--device", "cpu",
                          "verify"]) == 1
    port_out = capsys.readouterr().out
    assert ref_cli.main(["--root", str(tmp_path), "verify"]) == 1
    assert capsys.readouterr().out == port_out
    assert "CORRUPT" in port_out and "rank00000.dsllm" in port_out


def _mixed_policy(mod):
    """Params delta-routed (keyframe every 3), fp32 optimizer state
    quantized to int8."""
    return mod.CheckpointPolicy(
        engine=mod.EnginePolicy(host_cache_bytes=16 << 20),
        delta=mod.DeltaPolicy(keyframe_every=3),
        providers=(mod.StateProviderRegistry()
                   .add_rule(provider="quantized", domain="optimizer",
                             dtype="float32")
                   .add_rule(provider="auto")))


def _mixed_states():
    rng = np.random.default_rng(7)
    out = {}
    for step in (1, 2):
        out[step] = {"model": {"w": rng.standard_normal((64, 256))
                               .astype(np.float32)},
                     "optimizer": {"m": rng.standard_normal((64, 256))
                                   .astype(np.float32)}}
    return out


def _save_mixed(kind, root, states):
    if kind == "repro":
        import jax.numpy as jnp
        mgr = J.CheckpointManager.from_policy(str(root), _mixed_policy(J))
        for step, st in states.items():
            mgr.save(step, {d: {k: jnp.asarray(v) for k, v in t.items()}
                            for d, t in st.items()}, blocking=True)
    else:
        mgr = T.CheckpointManager.from_policy(str(root), _mixed_policy(T),
                                              device="cpu")
        for step, st in states.items():
            mgr.save(step, from_numpy_state(st, "cpu"), blocking=True)
    mgr.close()


def _port_restore(root, step, states):
    mgr = T.CheckpointManager.from_policy(str(root), device="cpu")
    try:
        got = mgr.restore(from_numpy_state(states[step], "cpu"), step=step)
    finally:
        mgr.close()
    return {d: {k: v.numpy() for k, v in t.items()} for d, t in got.items()}


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_int8_and_delta_steps_behave_as_in_the_reference(tmp_path, writer):
    """Step 1 (params keyframe, optimizer int8q): each package decodes the
    int8q tensor into raw fp32, and the consolidated step restores to the
    bytes the step restored to before, the same whichever package
    consolidated it. Step 2 (params an XOR delta): both refuse it, and
    leave the rank files and no aggregate."""
    states = _mixed_states()
    roots = {pkg: tmp_path / pkg for pkg in ("repro", "repro_torch")}
    for root in roots.values():
        _save_mixed(writer, root, states)
    before = _port_restore(roots["repro"], 1, states)
    ref_consolidate(T.step_dir(str(roots["repro"]), 1))
    consolidate_step_dir(T.step_dir(str(roots["repro_torch"]), 1),
                         device="cpu")
    for root in roots.values():
        sdir = T.step_dir(str(root), 1)
        assert sorted(os.listdir(sdir)) == ["agg00000.dsllm"] \
            + sorted(n for n in os.listdir(sdir) if not n.endswith(".dsllm"))
        after = _port_restore(root, 1, states)
        for d in before:
            for k in before[d]:
                assert np.array_equal(after[d][k].view(np.uint32),
                                      before[d][k].view(np.uint32)), (d, k)
        assert not np.array_equal(after["optimizer"]["m"],
                                  states[1]["optimizer"]["m"])
    with open(os.path.join(T.step_dir(str(roots["repro"]), 1),
                           "agg00000.dsllm"), "rb") as f:
        ref_bytes = f.read()
    with open(os.path.join(T.step_dir(str(roots["repro_torch"]), 1),
                           "agg00000.dsllm"), "rb") as f:
        assert f.read() == ref_bytes
    for consolidate in (ref_consolidate,
                        lambda s: consolidate_step_dir(s, device="cpu")):
        root = roots["repro" if consolidate is ref_consolidate
                     else "repro_torch"]
        sdir = T.step_dir(str(root), 2)
        files = sorted(os.listdir(sdir))
        with pytest.raises(ValueError, match="delta"):
            consolidate(sdir)
        assert sorted(os.listdir(sdir)) == files
        assert not any(n.startswith("agg") for n in files)
