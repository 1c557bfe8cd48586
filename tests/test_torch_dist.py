"""The port's multi-rank saves held against the JAX package's.

* ``partition_records`` (device locality, byte balance, the dead-rank
  re-spread) and ``node_topology`` give the reference's results on the
  same records.
* Interop both ways, bit for bit against the saved inputs:
  a world-4 step written by the port (thread runtime, node_size 2, state
  laid out ``tp_zero1`` on a (data 2 x model 4) mesh; chain K, delta,
  delta and a raw keyframe) restores through ``repro`` onto a (4 x 2)
  mesh and passes ``python -m repro.storage.cli verify``; a world-4 step
  written by ``repro`` (4 x 2 mesh; K, delta) restores through the port
  onto a (2 x 4) mesh and onto unsharded tensors. ``repro``'s side runs
  in one interpreter with 8 forced CPU devices.
* The fault matrix of ``tests/test_fault_injection.py`` on the thread
  runtime: a rank killed at each protocol point, or stalled, leaves an
  orphan the catalog never selects, and the next save commits; the
  phase-2 gate refuses a tampered step.
* The process runtime in six spawned children: a world-4 save with two
  node manifests, a SIGKILL ``mid_file`` followed by a committed
  re-keyframed save without the dead rank, and a stalled rank that trips
  the watchdog.
* The kernel build under its file lock from two processes at once.
"""

import json
import os
import subprocess
import sys
import textwrap
import time

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import run_in_subprocess  # noqa: E402
from faults import FaultInjector, InjectedFault  # noqa: E402

import repro.core.distributed as JD  # noqa: E402
import repro.dist as JDist  # noqa: E402
from repro.storage import cli as repro_cli  # noqa: E402

import repro_torch.core as T  # noqa: E402
from repro_torch.analysis import witness  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.convert import from_numpy_state  # noqa: E402
from repro_torch.core.distributed import ShardRecord  # noqa: E402
from repro_torch.core.tree import flatten_with_path, keystr  # noqa: E402
from repro_torch.dist import (BarrierBroken, CollectiveBarrier,  # noqa: E402
                              Coordinator, ProcessDied, ProcessFaultSpec,
                              node_topology, partition_records)
from repro_torch.dist.ipc import decode_record, encode_record  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models.model import param_shapes  # noqa: E402
from repro_torch.sharding import (opt_pspecs, param_pspecs,  # noqa: E402
                                  shard_tree, unshard)
from repro_torch.storage.manifest import (ManifestError,  # noqa: E402
                                          read_node_manifests,
                                          read_rank_manifests)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
WORLD = 4
NODE_SIZE = 2
#: one restore stream's rate in the throttled elastic restore: the smoke
#: state's ~18 MB take at least ~0.5 s
THROTTLE_MBPS = 40.0


# ----------------------------------------------------------------- records
def _records(pkg, n_dev: int, sizes, rank_of=None):
    return [pkg.ShardRecord(
        leaf_path=f"state/t{i}", tensor_name=f"state/t{i}@[0:{n}]",
        rank=(rank_of(i) if rank_of else i % n_dev), index=((0, n),),
        global_shape=(n,), shape=(n,), dtype="float32", nbytes=4 * n,
        data=None, device_resident=True) for i, n in enumerate(sizes)]


def _part(out):
    return {r: sorted(rec.tensor_name for rec in recs)
            for r, recs in out.items()}


SIZES = [700, 30, 512, 512, 9, 1024, 3, 256, 400, 77, 1, 640]


@pytest.mark.parametrize("n_dev,dead", [(8, ()), (8, (2,)), (1, ()),
                                        (1, (0,)), (3, (1, 3)), (2, (3,))])
def test_partition_records_matches_reference(n_dev, dead):
    """Device locality with at least as many devices as ranks, byte
    balance with fewer; a dead rank's slice re-spread over the survivors
    by byte balance seeded with their loads."""
    got = partition_records(_records(T, n_dev, SIZES), WORLD, dead=dead)
    want = JDist.partition_records(_records(JD, n_dev, SIZES), WORLD,
                                   dead=dead)
    assert _part(got) == _part(want)
    assert sorted(got) == sorted(r for r in range(WORLD) if r not in dead)


def test_partition_records_refuses_like_reference():
    for fn in (partition_records, JDist.partition_records):
        with pytest.raises(RuntimeError, match="no surviving"):
            fn([], 2, dead=(0, 1))
        with pytest.raises(ValueError, match="outside"):
            fn([], 2, dead=(5,))


@pytest.mark.parametrize("world,size", [(1, None), (4, 2), (5, 2), (9, None),
                                        (3, 8), (7, 3)])
def test_node_topology_matches_reference(world, size):
    assert node_topology(world, size) == JDist.node_topology(world, size)


def test_collective_barrier_poison_and_timeout():
    import threading
    b = CollectiveBarrier(2)
    results = []

    def party():
        try:
            results.append(b.wait(timeout=5))
        except BarrierBroken as exc:
            results.append(exc)

    t = threading.Thread(target=party)
    t.start()
    b.poison("rank 1 died", rank=1)
    t.join(timeout=5)
    assert not t.is_alive()
    assert isinstance(results[0], BarrierBroken) and results[0].rank == 1
    with pytest.raises(BarrierBroken):
        b.wait()
    b.reset()
    t2 = threading.Thread(target=party)
    t2.start()
    assert b.wait(timeout=5) == 0
    t2.join(timeout=5)
    assert not t2.is_alive()
    with pytest.raises(TimeoutError):
        b.wait_generation(5, timeout=0.05)
    assert not b.broken


def test_encode_record_ships_bf16_as_words():
    """A bfloat16 shard crosses the pipe as plain uint16 words named
    ``bfloat16`` (no ``ml_dtypes`` array), bytes unchanged."""
    t = torch.randn(3, 5).to(torch.bfloat16)
    rec = ShardRecord(leaf_path="state/x", tensor_name="state/x@[0:3,0:5]",
                      rank=2, index=((0, 3), (0, 5)), global_shape=(3, 5),
                      shape=(3, 5), dtype="bfloat16", nbytes=30, data=t,
                      device_resident=True)
    payload = encode_record(rec)
    assert payload["data"].dtype == np.uint16
    assert payload["data"].dtype.metadata is None
    back = decode_record(payload)
    assert back.dtype == "bfloat16" and not back.device_resident
    assert torch.equal(torch.from_numpy(back.data).view(torch.bfloat16), t)


# ------------------------------------------------------------ states, npz
def _states():
    """{step: numpy state}: smoke llama3.2-1b params (bf16) and fp32
    master/m/v plus a 0-d count, changing every step."""
    cfg = smoke_variant(get_config("llama3.2-1b"))
    flat, unflat = flatten_with_path(param_shapes(cfg))
    rng = np.random.default_rng(11)
    out = {}
    for step in (1, 2, 3, 4):
        params = [rng.standard_normal(s.shape).astype(np.float32)
                  for _p, s in flat]
        params = [x.astype(ml_dtypes.bfloat16) if s.dtype == "bfloat16"
                  else x for x, (_p, s) in zip(params, flat)]
        opt = {k: unflat([rng.standard_normal(s.shape).astype(np.float32)
                          for _p, s in flat]) for k in ("master", "m", "v")}
        opt["count"] = np.array(step, np.int32)
        out[step] = {"model": unflat(params), "optimizer": opt}
    return cfg, out


def _save_npz(path, states):
    arrays, dt = {}, {}
    for step, st in states.items():
        for p, x in flatten_with_path(st)[0]:
            key = f"{step}{keystr(p)}"
            dt[key] = x.dtype.name
            arrays[key] = x.view(np.uint16) if x.dtype.name == "bfloat16" \
                else x
    np.savez(path, **arrays)
    with open(path + ".json", "w") as f:
        json.dump(dt, f)


def _assert_tree_equal(got, want, what):
    g = {keystr(p): x for p, x in flatten_with_path(got)[0]}
    w = {keystr(p): x for p, x in flatten_with_path(want)[0]}
    assert sorted(g) == sorted(w), what
    for k, x in w.items():
        a = g[k]
        if isinstance(a, torch.Tensor):
            a = a.contiguous().view(torch.uint8).numpy() if a.ndim else \
                a.reshape(1).view(torch.uint8).numpy()
            b = np.ascontiguousarray(x).reshape(-1).view(np.uint8)
            assert np.array_equal(a.reshape(-1), b), f"{what}: {k}"
        else:
            assert a == x, f"{what}: {k}"


def _tp_zero1(cfg):
    import dataclasses
    return dataclasses.replace(cfg, sharding_mode="tp_zero1")


def _specs(cfg, state, mesh):
    return {"model": param_pspecs(cfg, state["model"], mesh),
            "optimizer": opt_pspecs(cfg, state["model"], mesh)}


# The JAX side of the interop: restore the port's steps onto a (4 x 2)
# mesh, then save its own world-4 steps from a (4 x 2) layout.
REFERENCE = r"""
import dataclasses, json, os, sys, time
import jax, jax.numpy as jnp, ml_dtypes, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
import repro.core as J
from repro.configs import get_config, smoke_variant
from repro.launch.mesh import make_mesh
from repro.models.model import init_params
from repro.optim.adamw import init_opt_state
from repro.sharding.partition import opt_pspecs, param_pspecs

npz, port_dir, repro_dir = sys.argv[1:4]
data = np.load(npz)
dts = json.load(open(npz + ".json"))
cfg = dataclasses.replace(smoke_variant(get_config("llama3.2-1b")),
                          sharding_mode="tp_zero1")
mesh = make_mesh((4, 2), ("data", "model"))
params = jax.eval_shape(lambda: init_params(cfg, jax.random.PRNGKey(0)))
shapes = {"model": params,
          "optimizer": jax.eval_shape(init_opt_state, params)}
specs = {"model": param_pspecs(cfg, params, mesh),
         "optimizer": opt_pspecs(cfg, params, mesh)}
flat, tdef = jax.tree_util.tree_flatten_with_path(shapes)
sflat = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(x, P))

def value(step, p):
    key = f"{step}{jax.tree_util.keystr(p)}"
    x = data[key]
    return x.view(ml_dtypes.bfloat16) if dts[key] == "bfloat16" else x

def state(step):
    leaves = [jax.device_put(value(step, p), NamedSharding(mesh, s))
              for (p, _l), s in zip(flat, sflat)]
    tree = jax.tree_util.tree_unflatten(tdef, leaves)
    tree["meta"] = {"step": step}
    return tree

template = jax.tree_util.tree_unflatten(tdef, [
    jax.ShapeDtypeStruct(l.shape, l.dtype, sharding=NamedSharding(mesh, s))
    for (_p, l), s in zip(flat, sflat)])
template["meta"] = {"step": 0}
mgr = J.CheckpointManager.from_policy(port_dir)
for step in (4, 3, 1):
    got = mgr.restore(template, step=step)
    assert got["meta"]["step"] == step, got["meta"]
    for (p, _l), g in zip(flat, jax.tree_util.tree_leaves(
            {"model": got["model"], "optimizer": got["optimizer"]})):
        assert g.sharding.mesh.devices.shape == (4, 2)
        want = value(step, p)
        assert np.asarray(g).tobytes() == np.ascontiguousarray(
            want).tobytes(), (step, jax.tree_util.keystr(p))
mgr.close()
# a throttled elastic restore of the port's keyframe, one stream: its
# counts and its time, for the port's to be held against
t0 = time.perf_counter()
got, st = J.RestoreEngine(threads=1, throttle_mbps=THROTTLE_MBPS).restore(
    os.path.join(port_dir, "global_step4"), template)
secs = time.perf_counter() - t0
print("THROTTLED " + json.dumps({"bytes_read": st.bytes_read,
                                 "n_ranges": st.n_ranges, "s": secs}))
pol = J.CheckpointPolicy(dist=J.DistPolicy(world=4, node_size=2),
                         delta=J.DeltaPolicy(keyframe_every=3))
mgr = J.CheckpointManager.from_policy(repro_dir, pol)
for step in (1, 2):
    mgr.save(step, state(step), blocking=True)
assert mgr.commit_errors == [], mgr.commit_errors
mgr.close()
print("REFERENCE OK")
"""


@pytest.fixture(scope="module")
def interop(tmp_path_factory):
    """The port writes ``port`` (world 4, thread runtime, node_size 2,
    K/delta/delta then a keyframe), ``repro`` restores it and writes
    ``repro`` (world 4, K then delta) in one 8-device interpreter."""
    root = tmp_path_factory.mktemp("interop")
    cfg, states = _states()
    cfg = _tp_zero1(cfg)
    npz = str(root / "states.npz")
    _save_npz(npz, states)
    port_dir, repro_dir = str(root / "port"), str(root / "repro")
    mesh = make_mesh((2, 4), ("data", "model"), "cpu")
    pol = T.CheckpointPolicy(
        engine=T.EnginePolicy(host_cache_bytes=64 << 20, flush_threads=4),
        dist=T.DistPolicy(world=WORLD, node_size=NODE_SIZE),
        delta=T.DeltaPolicy(keyframe_every=3))
    mgr = T.CheckpointManager.from_policy(port_dir, pol, device="cpu")
    try:
        for step in (1, 2, 3, 4):
            st = from_numpy_state(states[step], "cpu")
            placed = shard_tree(st, _specs(cfg, st, mesh), mesh)
            placed["meta"] = {"step": step}
            mgr.save(step, placed, blocking=True)
        assert mgr.commit_errors == []
        kinds = [mgr.repository.manifest(s).meta["delta"]["keyframe"]
                 for s in (1, 2, 3, 4)]
    finally:
        mgr.close()
    out = run_in_subprocess(
        "import sys\nsys.argv = [''] + %r\nTHROTTLE_MBPS = %r\n"
        % ([npz, port_dir, repro_dir], THROTTLE_MBPS) + REFERENCE,
        n_devices=8)
    assert "REFERENCE OK" in out
    throttled = json.loads(next(line for line in out.splitlines()
                                if line.startswith("THROTTLED "))[10:])
    return {"cfg": cfg, "states": states, "port": port_dir,
            "repro": repro_dir, "kinds": kinds, "throttled": throttled}


def test_port_world4_step_has_every_vote(interop):
    assert interop["kinds"] == [True, False, False, True]
    for step in (1, 2, 3, 4):
        sdir = os.path.join(interop["port"], f"global_step{step}")
        assert sorted(read_rank_manifests(sdir)) == [0, 1, 2, 3]
        nodes = read_node_manifests(sdir)
        assert sorted(nodes) == [0, 1]
        assert nodes[0].ranks == [0, 1] and nodes[1].ranks == [2, 3]
        names = sorted(n for n in os.listdir(sdir) if n.endswith(".dsllm"))
        assert names == [f"rank{r:05d}.dsllm" for r in range(WORLD)]
    man = T.CheckpointManager.from_policy(interop["port"], device="cpu")
    try:
        meta = man.repository.manifest(3).meta
        assert meta["world"] == WORLD
        assert meta["nodes"] == {"0": [0, 1], "1": [2, 3]}
        assert "writers" not in meta  # the full writer set
    finally:
        man.close()


def test_port_world4_step_passes_repro_verify(interop):
    assert repro_cli.main(["--root", interop["port"], "verify"]) == 0


def test_repro_world4_step_restores_through_the_port(interop):
    cfg, states = interop["cfg"], interop["states"]
    mesh = make_mesh((2, 4), ("data", "model"), "cpu")
    mgr = T.CheckpointManager.from_policy(interop["repro"], device="cpu")
    try:
        sdir = os.path.join(interop["repro"], "global_step2")
        assert sorted(read_rank_manifests(sdir)) == [0, 1, 2, 3]
        assert sorted(read_node_manifests(sdir)) == [0, 1]
        for step in (2, 1):
            plain = from_numpy_state(states[step], "cpu")
            zeros = {k: {**v} if isinstance(v, dict) else v
                     for k, v in plain.items()}
            sharded = shard_tree(zeros, _specs(cfg, plain, mesh), mesh)
            sharded["meta"] = {"step": 0}
            got = mgr.restore(sharded, step=step)
            assert got["meta"]["step"] == step
            leaf = got["model"]["embed"]["embed"]
            assert leaf.mesh == mesh and leaf.spec == ("model", None)
            _assert_tree_equal(unshard({"model": got["model"],
                                        "optimizer": got["optimizer"]}),
                               states[step], f"sharded step {step}")
            got = mgr.restore({"model": plain["model"],
                               "optimizer": plain["optimizer"]}, step=step)
            _assert_tree_equal(got, states[step], f"unsharded step {step}")
    finally:
        mgr.close()


def test_port_restores_its_chain_onto_another_mesh_and_world(interop):
    """The N-rank chain restores elastically in the port too: onto a
    (4 x 2) mesh, and through a world-1 manager."""
    cfg, states = interop["cfg"], interop["states"]
    mesh = make_mesh((4, 2), ("data", "model"), "cpu")
    mgr = T.CheckpointManager.from_policy(interop["port"], device="cpu")
    try:
        plain = from_numpy_state(states[3], "cpu")
        tmpl = shard_tree(plain, _specs(cfg, plain, mesh), mesh)
        got = mgr.restore(tmpl, step=3)
        assert got["optimizer"]["m"]["embed"]["embed"].mesh == mesh
        _assert_tree_equal(unshard(got), states[3], "chain step 3")
    finally:
        mgr.close()


def test_throttled_elastic_restore_matches_reference(interop):
    """The port's keyframe restored onto a (4 x 2) mesh by one throttled
    stream reads the reference's bytes in the reference's ranges (the
    coalesced spans' gaps are not counted), and both take at least those
    bytes over the rate."""
    cfg, states = interop["cfg"], interop["states"]
    ref = interop["throttled"]
    mesh = make_mesh((4, 2), ("data", "model"), "cpu")
    plain = from_numpy_state(states[4], "cpu")
    tmpl = shard_tree(plain, _specs(cfg, plain, mesh), mesh)
    tmpl["meta"] = {"step": 0}
    t0 = time.perf_counter()
    got, st = T.RestoreEngine("cpu", threads=1,
                              throttle_mbps=THROTTLE_MBPS).restore(
        os.path.join(interop["port"], "global_step4"), tmpl)
    secs = time.perf_counter() - t0
    _assert_tree_equal(unshard({"model": got["model"],
                                "optimizer": got["optimizer"]}),
                       states[4], "throttled elastic step 4")
    assert (st.bytes_read, st.n_ranges) == (ref["bytes_read"],
                                            ref["n_ranges"])
    floor = st.bytes_read / (THROTTLE_MBPS * 1e6)
    assert secs >= floor and ref["s"] >= floor


# ------------------------------------------------- thread-runtime faults
@pytest.fixture
def lock_witness():
    with witness.recording() as w:
        yield w
    w.assert_clean()


def _tiny(tag: float):
    return {"model": {f"w{i}": torch.arange(256, dtype=torch.float32)
                      + tag + i for i in range(2 * 3)},
            "meta": {"step": int(tag)}}


def _thread_manager(root, injector, ack_timeout_s=30.0, checksum=True):
    coord = Coordinator(3, device="cpu", fault_hook=injector,
                        ack_timeout_s=ack_timeout_s, checksum_files=checksum)
    return T.CheckpointManager.from_policy(root, T.CheckpointPolicy(
        storage=T.StoragePolicy(manifest_checksums=checksum),
        dist=T.DistPolicy(coordinator=coord)), device="cpu")


def _assert_orphan_never_selected(root: str, latest: int):
    """Step 2's save was killed: the catalog never selects it, the
    newest committed step restores, and the reference's CLI flags the
    orphan and its GC reclaims exactly the victim."""
    assert T.latest_step(root) == latest
    mgr = T.CheckpointManager.from_policy(root, device="cpu")
    try:
        assert 2 not in mgr.repository.steps()
        out = mgr.restore(_tiny(0.0))
        assert mgr.last_restored_step == latest
        assert float(out["model"]["w0"][1]) == latest + 1.0
    finally:
        mgr.close()
    assert repro_cli.main(["--root", root, "verify"]) == 1
    assert repro_cli.main(["--root", root, "gc", "--orphans",
                           "--orphan-grace", "0"]) == 0
    assert not os.path.isdir(T.step_dir(root, 2))
    assert os.path.isdir(T.step_dir(root, 1))
    assert repro_cli.main(["--root", root, "verify"]) == 0


@pytest.mark.parametrize("point", ["mid_file", "after_upload", "before_ack"])
def test_killed_rank_leaves_no_commit(tmp_path, lock_witness, point):
    """Rank 1 killed at each window of the protocol: data without a vote,
    a truncated file, or a full vote without an ack — the global commit
    is absent in every case, and the next save commits."""
    injector = FaultInjector(point, rank=1, step=2)
    root = str(tmp_path)
    mgr = _thread_manager(root, injector)
    try:
        mgr.save(1, _tiny(1.0), blocking=True)
        with pytest.raises(T.CheckpointError) as ei:
            mgr.save(2, _tiny(2.0), blocking=True)
        assert isinstance(ei.value.__cause__, (InjectedFault, BarrierBroken))
        assert injector.fired.is_set()
        mgr.wait_for_commit(timeout=60)
        assert not mgr.repository.has_manifest(2)
        assert mgr.latest_step() == 1
        mgr.drain()  # the survivors finish their part of the failed save
        sdir = T.step_dir(root, 2)
        if point == "before_ack":
            # every file and every vote on disk, yet phase 2 never ran
            assert len(read_rank_manifests(sdir)) == 3
        else:
            assert 1 not in read_rank_manifests(sdir)
        mgr.save(3, _tiny(3.0), blocking=True)
        assert mgr.commit_errors == [] and mgr.latest_step() == 3
    finally:
        mgr.close()
    _assert_orphan_never_selected(root, 3)


def test_stalled_rank_times_out_without_commit(tmp_path, lock_witness):
    injector = FaultInjector("before_ack", rank=2, step=2, action="stall")
    root = str(tmp_path)
    mgr = _thread_manager(root, injector, ack_timeout_s=1.0, checksum=False)
    try:
        mgr.save(1, _tiny(1.0), blocking=True)
        fut = mgr.save(2, _tiny(2.0))
        with pytest.raises(T.CheckpointError) as ei:
            fut.wait_persisted(timeout=30)
        assert isinstance(ei.value.__cause__, TimeoutError)
        mgr.wait_for_commit(timeout=60)
        assert not mgr.repository.has_manifest(2)
        assert mgr.commit_errors == []
        injector.release()
        mgr.drain()
        assert not mgr.repository.has_manifest(2)
    finally:
        injector.release()
        mgr.close()
    _assert_orphan_never_selected(root, 1)


def test_commit_gate_rejects_tampered_step(tmp_path):
    root = str(tmp_path)
    mgr = _thread_manager(root, None)
    try:
        mgr.save(1, _tiny(1.0), blocking=True)
    finally:
        mgr.close()
    sdir = T.step_dir(root, 1)
    mgr = T.CheckpointManager.from_policy(root, device="cpu")
    repo = mgr.repository
    try:
        with open(os.path.join(sdir, "rank00099.dsllm"), "wb") as f:
            f.write(os.urandom(64))
        with pytest.raises(ManifestError, match="not\\s+declared"):
            repo.commit_step(1, expect_ranks=3)
        os.unlink(os.path.join(sdir, "rank00099.dsllm"))
        with pytest.raises(ManifestError, match="expects ranks \\[0, 1\\]"):
            repo.commit_step(1, expect_ranks=3, nodes={0: [0, 1]})
        with pytest.raises(ManifestError, match="missing for nodes \\[1\\]"):
            repo.commit_step(1, expect_ranks=3, nodes={1: [0, 1, 2]})
        os.unlink(os.path.join(sdir, "rank00001.manifest.json"))
        with pytest.raises(ManifestError, match="missing"):
            repo.commit_step(1, expect_ranks=3)
    finally:
        mgr.close()


def test_world4_refuses_baseline_engines(tmp_path):
    with pytest.raises(ValueError, match="DataMovementEngine mode"):
        T.CheckpointManager.from_policy(str(tmp_path), T.CheckpointPolicy(
            engine=T.EnginePolicy(mode="snapshot"),
            dist=T.DistPolicy(world=2)), device="cpu")


# --------------------------------------------------------- process runtime
def _proc_state(seed: int = 7):
    rng = np.random.default_rng(seed)
    return {"model": {f"w{i:02d}": torch.from_numpy(
        rng.standard_normal(3000 + i).astype(np.float32))
        for i in range(8)},
        "meta": {"note": "proc-runtime"}}


def _proc_manager(root, coord, **kw):
    return T.CheckpointManager.from_policy(root, T.CheckpointPolicy(
        storage=T.StoragePolicy(manifest_checksums=False),
        dist=T.DistPolicy(coordinator=coord), **kw), device="cpu")


def _assert_restores(mgr, state, step):
    zeros = {"model": {k: torch.zeros_like(v)
                       for k, v in state["model"].items()},
             "meta": {"note": ""}}
    got = mgr.restore(zeros, step=step)
    for k, v in state["model"].items():
        assert torch.equal(got["model"][k], v), k
    assert got["meta"] == state["meta"]


def test_process_world4_commits_then_survives_a_sigkill(tmp_path):
    """Four spawned ranks in two nodes: a clean save (four rank files,
    four votes, two node manifests, child spans merged into the parent's
    trace); rank 3 SIGKILLed mid-file on the next save leaves an orphan;
    the save after that commits without it, re-keyframed."""
    from repro_torch.obs import trace as obs
    root = str(tmp_path)
    coord = Coordinator(WORLD, device="cpu", runtime="process",
                        node_size=NODE_SIZE, host_cache_bytes=16 << 20,
                        flush_threads=1, checksum_files=False,
                        ack_timeout_s=60.0,
                        fault=ProcessFaultSpec("mid_file", rank=3, step=2))
    mgr = _proc_manager(root, coord, delta=T.DeltaPolicy(keyframe_every=4))
    try:
        state = _proc_state()
        with obs.tracing() as tracer:
            fut = mgr.save(1, state)
            fut.wait_persisted(timeout=60)
            mgr.wait_for_commit(1, timeout=60)
        assert mgr.commit_errors == [] and mgr.latest_step() == 1
        # every rank reports its own launches; on the CPU the wrappers
        # run their plain versions, so none launched
        launches = fut.stats.extra["kernel_launches"]
        assert sorted(launches) == [0, 1, 2, 3]
        assert all("ckpt_checksum_u32" in c and not any(c.values())
                   for c in launches.values())
        sdir = T.step_dir(root, 1)
        assert sorted(read_rank_manifests(sdir)) == [0, 1, 2, 3]
        assert sorted(read_node_manifests(sdir)) == [0, 1]
        assert len([n for n in os.listdir(sdir)
                    if n.endswith(".dsllm")]) == WORLD
        names = {e["name"] for e in tracer.events()}
        assert {"vote", "node.vote", "rank.ship"} <= names
        assert any(e.get("lane", "").startswith("rank000")
                   for e in tracer.events())

        fut = mgr.save(2, state)
        with pytest.raises(T.CheckpointError) as ei:
            fut.wait_persisted(timeout=60)
        assert isinstance(ei.value.__cause__, ProcessDied)
        assert ei.value.__cause__.rank == 3
        mgr.wait_for_commit(2, timeout=60)
        assert mgr.latest_step() == 1
        assert 3 in coord.dead_ranks

        state3 = _proc_state(8)
        mgr.save(3, state3).wait_persisted(timeout=60)
        mgr.wait_for_commit(3, timeout=60)
        assert mgr.commit_errors == [] and mgr.latest_step() == 3
        meta = mgr.repository.manifest(3).meta
        assert meta["writers"] == [0, 1, 2]
        assert meta["nodes"] == {"0": [0, 1], "1": [2]}
        assert meta["delta"]["keyframe"] is True  # the writer set changed
        assert not os.path.exists(os.path.join(T.step_dir(root, 3),
                                               "rank00003.dsllm"))
        _assert_restores(mgr, state3, 3)
        _assert_restores(mgr, state, 1)
    finally:
        mgr.close()
    assert not any(rt._proc.is_alive() for rt in coord.ranks)


def test_process_stalled_rank_trips_the_watchdog(tmp_path):
    root = str(tmp_path)
    coord = Coordinator(2, device="cpu", runtime="process",
                        host_cache_bytes=16 << 20, flush_threads=1,
                        checksum_files=False, ack_timeout_s=2.0,
                        fault=ProcessFaultSpec("before_ack", rank=1, step=2,
                                               action="stall", stall_s=5.0))
    mgr = _proc_manager(root, coord)
    try:
        state = _proc_state()
        # a first save waits out the children's start-up
        mgr.save(1, state).wait_persisted(timeout=60)
        mgr.wait_for_commit(1, timeout=60)
        fut = mgr.save(2, state)
        with pytest.raises(T.CheckpointError) as ei:
            fut.wait_persisted(timeout=60)
        assert isinstance(ei.value.__cause__, TimeoutError)
        mgr.wait_for_commit(2, timeout=60)
        assert mgr.latest_step() == 1
    finally:
        mgr.close()
    assert not any(rt._proc.is_alive() for rt in coord.ranks)


@pytest.mark.gpu
def test_process_runtime_on_the_card(tmp_path):
    """Two spawned ranks on the card: shards shipped from device memory,
    the children's engines and checksums on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    root = str(tmp_path)
    mgr = T.CheckpointManager.from_policy(root, T.CheckpointPolicy(
        dist=T.DistPolicy(world=2, runtime="process")), device="cuda")
    try:
        state = {"model": {k: v.cuda() for k, v in
                           _proc_state()["model"].items()},
                 "meta": {"note": "card"}}
        fut = mgr.save(1, state)
        fut.wait_persisted(timeout=60)
        mgr.wait_for_commit(1, timeout=60)
        assert mgr.commit_errors == []
        assert fut.stats.extra["device_peak_bytes"].keys() == {0, 1}
        launches = fut.stats.extra["kernel_launches"]
        assert launches.keys() == {0, 1}
        assert all(c["ckpt_checksum_u32"] > 0 for c in launches.values())
        _assert_restores(mgr, state, 1)
    finally:
        mgr.close()


# ------------------------------------------------------------- build lock
FAKE_NVCC = r"""#!{python}
import os, sys, time
args = sys.argv[1:]
out = args[args.index("-o") + 1]
with open(os.environ["FAKE_NVCC_LOG"], "a") as f:
    f.write(("link" if "-shared" in args else "compile") + "\n")
time.sleep(0.3)
with open(out, "wb") as f:
    f.write(b"built")
"""

BUILDER = r"""
import sys, time
from pathlib import Path
from repro_torch.kernels import build
build.BUILD_DIR = Path(sys.argv[1])
out = build.build()
print(out.name, out.read_bytes().decode())
"""


def test_kernel_build_runs_once_under_the_file_lock(tmp_path):
    """Two processes build at once: one compiles (each source once, one
    link) while the other waits on the lock and finds the library; no
    temporary file is left."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text(FAKE_NVCC.replace("{python}", sys.executable))
    nvcc.chmod(0o755)
    log = tmp_path / "nvcc.log"
    env = dict(os.environ, PYTHONPATH=SRC, FAKE_NVCC_LOG=str(log),
               PATH=f"{bindir}{os.pathsep}{os.environ['PATH']}")
    build_dir = tmp_path / "build"
    procs = [subprocess.Popen([sys.executable, "-c", BUILDER,
                               str(build_dir)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=60) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert outs[0][0] == outs[1][0] and outs[0][0].split()[1] == "built"
    assert log.read_text().split() == ["compile", "compile", "link"]
    left = sorted(p.name for p in build_dir.iterdir())
    assert [n for n in left if "tmp" in n] == []


def test_build_lock_excludes_a_second_process(tmp_path):
    """The lock itself: a second process blocks on it until the first
    lets go."""
    from repro_torch.kernels import build
    code = textwrap.dedent("""
        import sys, time
        from pathlib import Path
        from repro_torch.kernels.build import build_lock
        with build_lock(Path(sys.argv[1])):
            print(time.monotonic(), flush=True)
    """)
    env = dict(os.environ, PYTHONPATH=SRC)
    with build.build_lock(tmp_path):
        t_held = time.monotonic()
        p = subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                             env=env, stdout=subprocess.PIPE, text=True)
        time.sleep(1.0)
        assert p.poll() is None  # still waiting on the lock
        t_release = time.monotonic()
    out, _ = p.communicate(timeout=60)
    assert p.returncode == 0
    assert float(out.split()[0]) >= t_release > t_held
