"""``DTensor`` state checkpointed rank by rank, held against the
single-process ``ShardedTensor`` save and against the JAX package.

The counterparts of ``tests/test_distributed.py``'s three tests on
``DTensor``s: one group of four spawned ranks (gloo on the CPU) holds a
``(data 2, model 2)`` ``DeviceMesh``, and a ``CheckpointManager`` with
``DistPolicy(group=True)`` runs on every rank; the functions the ranks
run are in ``tests/test_torch_spmd.py``.

* A weight split over both axes, a ZeRO-1 leaf split over ``data`` and a
  replicated leaf: one rank file a rank, the replicated leaf stored once,
  the ZeRO-1 leaf as 2 unique shards, each rank's bytes a quarter of the
  weight; a same-mesh restore, an elastic one onto ``(1, 4)`` and one at
  world 1; each rank file's records equal, name for name and byte for
  byte, to those the single-process ``ShardedTensor`` save writes for the
  same mesh and specs; ``repro`` restores the step bit-exactly and
  ``python -m repro.storage.cli verify`` passes it; a step ``repro``
  writes restores into ``DTensor``s on the four ranks.
* The llama3.2-1b smoke variant's sharded train step in ``tp_zero1``,
  its state saved blocking and lazily beside the next step (the capture
  barrier before the in-place update), both restored bit-exactly; the
  rank files again equal the ``ShardedTensor`` save's.
* The smoke variant's state after a ``tp_zero1`` step saved and
  restored onto the ``2d`` layout, and by ``repro``, bit for bit; the
  rank files hold exactly the state's unique bytes.
* A ZeRO-1 leaf over the whole mesh planned at a quarter a rank.
* The rank runtime's ``torch_distributed`` flag: no rendezvous joins
  nothing, a configured one joins every rank, a failing one raises.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import CheckpointManager as JManager
from repro.storage import cli as jcli
from repro_torch.core import CheckpointManager
from repro_torch.core.layout import FileReader
from repro_torch.core.policy import (CheckpointPolicy, DistPolicy,
                                     StoragePolicy)
from repro_torch.core.tree import flatten_with_path, map_leaves, path_str
from repro_torch.dist.coordinator import Coordinator
from repro_torch.dist.worker import join_process_group
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.spmd import SpmdGroup, free_port
from repro_torch.sharding import shard_tree
from test_torch_spmd import (AXES, SPECS, _at, _rank_basic,
                             _rank_collectives, _rank_train_save,
                             _rank_zero1_to_2d, _tensors, _train_cfg)


@pytest.fixture(scope="module")
def group():
    with SpmdGroup(4, device="cpu", threads=1, timeout_s=300) as g:
        yield g


def _arrays():
    return {"params": {"w": np.arange(64 * 32, dtype=np.float32)
                       .reshape(64, 32)},
            "opt": {"m": np.random.default_rng(0).standard_normal(
                (64, 32)).astype(np.float32)},
            "repl": np.arange(16.0, dtype=np.float32)}


# ------------------------------------------------------------ rank bodies


# ---------------------------------------------------------------- helpers
def _rank_files(sdir):
    return sorted(glob.glob(os.path.join(sdir, "rank*.dsllm")))


def _records(path):
    r = FileReader(path)
    return {n: r.read_tensor(n, "cpu").tobytes() for n in r.tensor_names()}


def _sharded_save(root, step, tree, specs):
    """The single-process save of ``tree`` laid out as ShardedTensors on
    the same (2, 2) mesh by the same specs."""
    mesh = make_mesh((2, 2), AXES, "cpu")
    with CheckpointManager.from_policy(root, device="cpu") as mgr:
        state = shard_tree(tree, specs, mesh)
        state["meta"] = {"step": step}
        mgr.save(step, state, blocking=True)
    return os.path.join(root, f"global_step{step}")


def _assert_same_records(sdir, ref_sdir):
    files, ref = _rank_files(sdir), _rank_files(ref_sdir)
    assert [os.path.basename(f) for f in files] \
        == [os.path.basename(f) for f in ref]
    for f, g in zip(files, ref):
        assert _records(f) == _records(g), os.path.basename(f)


def test_group_save_dedup_and_elastic_restore(group, tmp_path):
    arrays = _arrays()
    root, jroot = str(tmp_path / "port"), str(tmp_path / "repro")
    # a step written by repro (one process, unsharded), for the ranks
    jmgr = JManager.from_policy(jroot)
    jstate = jax.tree_util.tree_map(jnp.asarray, arrays)
    jstate["meta"] = {"step": 5}
    jmgr.save(5, jstate, blocking=True)
    jmgr.close()
    res = group.run(_rank_basic, root, jroot, arrays)
    for r in res:
        assert r["same"] and r["from_repro"] and r["commit_errors"] == []
        assert r["meta"] == {"step": 3} and r["elastic_meta"] == {"step": 3}
        assert all(ok for _n, ok, _s in r["elastic"])
        # (1, 4): w's rows over model, m's columns over model
        assert dict((n, s) for n, _ok, s in r["elastic"]) == {
            "params/w": (16, 32), "opt/m": (64, 8), "repl": (16,)}
        assert r["zero1_bytes"] == {q: 1024 * 64 * 4 // 4 for q in range(4)}
    sdir = os.path.join(root, "global_step3")
    files = _rank_files(sdir)
    assert [os.path.basename(f) for f in files] \
        == [f"rank{r:05d}.dsllm" for r in range(4)]
    names = [n for f in files for n in FileReader(f).tensor_names()]
    assert sum(n.startswith("state/repl") for n in names) == 1
    assert sum(n.startswith("state/opt/m") for n in names) == 2
    w_bytes = [sum(e.nbytes for n, e in FileReader(f).tensors.items()
                   if n.startswith("state/params/w")) for f in files]
    assert w_bytes == [64 * 32 * 4 // 4] * 4
    m_bytes = sorted(sum(e.nbytes for n, e in FileReader(f).tensors.items()
                         if n.startswith("state/opt/m")) for f in files)
    assert m_bytes == [0, 0, 64 * 32 * 4 // 2, 64 * 32 * 4 // 2]
    _assert_same_records(sdir, _sharded_save(str(tmp_path / "st"), 3,
                                             _tensors(arrays), SPECS))
    # world 1: the port with plain tensors, repro with jax arrays
    tpl = map_leaves(torch.zeros_like, _tensors(arrays))
    tpl["meta"] = {"step": 0}
    with CheckpointManager.from_policy(root, device="cpu") as mgr:
        got = mgr.restore(tpl, step=3)
    jtpl = jax.tree_util.tree_map(jnp.zeros_like,
                                  jax.tree_util.tree_map(jnp.asarray, arrays))
    jtpl["meta"] = {"step": 0}
    jgot = JManager.from_policy(root).restore(jtpl, step=3)
    for p, want in flatten_with_path(arrays)[0]:
        np.testing.assert_array_equal(_at(got, p).numpy(), want)
        np.testing.assert_array_equal(np.asarray(_at(jgot, p)), want)
    assert got["meta"] == {"step": 3} and jgot["meta"] == {"step": 3}
    # ``python -m repro.storage.cli --root ROOT verify``, in this process
    assert jcli.main(["--root", root, "verify"]) == 0


def test_sharded_train_state_saves_blocking_and_lazily(group, tmp_path):
    from repro_torch.models import model as TM
    cfg = _train_cfg()
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            torch.device("cpu"))
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab, (4, 32)).astype(np.int32)
    root = str(tmp_path / "port")
    res = group.run(_rank_train_save, root, params, tokens)
    for r in res:
        assert r[1] and r[2] and r["commit_errors"] == []
    snaps, specs = res[0]["snaps"], res[0]["specs"]
    for step in (1, 2):
        _assert_same_records(
            os.path.join(root, f"global_step{step}"),
            _sharded_save(str(tmp_path / f"st{step}"), step, snaps[step],
                          specs))
    # repro restores the lazily saved step bit for bit
    _assert_repro_restores(root, 2, snaps[2])


def _assert_repro_restores(root, step, want):
    """``repro`` restores ``step`` of ``root`` bit for bit equal to
    ``want`` (a tree of whole tensors)."""
    def zeros(t):
        dt = jnp.bfloat16 if t.dtype == torch.bfloat16 \
            else np.dtype(str(t.dtype).replace("torch.", ""))
        return jnp.zeros(tuple(t.shape), dt)
    jgot = JManager.from_policy(root).restore(map_leaves(zeros, want),
                                              step=step)
    for (p, w), (_q, got) in zip(flatten_with_path(want)[0],
                                 flatten_with_path(jgot)[0]):
        got = np.atleast_1d(np.asarray(got))
        w = w.reshape(-1)
        if w.dtype == torch.bfloat16:
            got, w = got.view(np.uint16), w.view(torch.int16)
        np.testing.assert_array_equal(got.reshape(-1).view(np.uint8),
                                      w.numpy().view(np.uint8),
                                      err_msg=path_str(p))


def test_zero1_save_restores_onto_2d_layout(group, tmp_path):
    """The llama3.2-1b smoke variant's state after a ``tp_zero1`` step on
    the ranks (the paper's layout: params replicated over ``data``, their
    optimizer state split over it), saved, restored onto the ``2d``
    (2, 2) layout bit for bit (a change of partition mode on resume) and
    by ``repro`` bit for bit; a leaf replicated over ``data`` is written
    once, so the rank files hold exactly the state's unique bytes."""
    import dataclasses

    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.models import model as TM
    cfg = dataclasses.replace(smoke_variant(get_config("llama3.2-1b")),
                              dtype="float32", sharding_mode="tp_zero1")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            torch.device("cpu"))
    params_np = map_leaves(lambda t: t.detach().numpy(), params)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab, (4, 32)).astype(np.int32)
    root = str(tmp_path / "port")
    res = group.run(_rank_zero1_to_2d, root, cfg, params_np, tokens)
    d, hdh = params_np["groups"][0][0]["attn"]["wq"].shape[1:]
    for r in res:
        assert r["exact"] and r["meta"] == {"step": 1}
        assert r["commit_errors"] == []
        # wq and its fp32 master: (model) and (data, model) in tp_zero1,
        # (data, model) for both in 2d
        assert r["layouts"] == {
            "tp_zero1": ((1, d, hdh // 2), (1, d // 2, hdh // 2)),
            "2d": ((1, d // 2, hdh // 2), (1, d // 2, hdh // 2))}
    saved = res[0]["saved"]
    files = _rank_files(os.path.join(root, "global_step1"))
    assert len(files) == 4
    assert sum(e.nbytes for f in files
               for e in FileReader(f).tensors.values()) \
        == sum(t.numel() * t.element_size() for _p, t in
               flatten_with_path(saved)[0])
    _assert_repro_restores(root, 1, saved)


def test_torch_distributed_flag(tmp_path, monkeypatch):
    state = {"model": {"w": torch.arange(4096.0)}, "meta": {"n": 1}}

    def save(tag):
        coord = Coordinator(2, device="cpu", runtime="process",
                            host_cache_bytes=8 << 20, flush_threads=1,
                            checksum_files=False, ack_timeout_s=60.0,
                            torch_distributed=True)
        mgr = CheckpointManager.from_policy(
            str(tmp_path / tag), CheckpointPolicy(
                storage=StoragePolicy(manifest_checksums=False),
                dist=DistPolicy(coordinator=coord)), device="cpu")
        try:
            mgr.save(1, state, blocking=True)
            return [rt.group_world for rt in coord.ranks], \
                mgr.latest_step(), list(mgr.commit_errors)
        finally:
            mgr.close()

    with pytest.raises(ValueError, match="runtime='process'"):
        Coordinator(2, device="cpu", torch_distributed=True)
    # no rendezvous configured: a rank joins nothing (``worker_main``
    # calls this before its ``ready``)
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    assert join_process_group(0, 2) is None
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", str(free_port()))
    assert save("joined") == ([2, 2], 1, [])
    # a rendezvous that is configured and fails (a port that is not one)
    # raises in the rank, before its ``ready``, where the reference's
    # swallows it (the parent then sees the rank die, as a rank that
    # cannot reach the card: ``tests/test_torch_dist.py``)
    monkeypatch.setenv("MASTER_PORT", "not-a-port")
    with pytest.raises(ValueError):
        join_process_group(0, 2)


def test_gloo_collectives_route_matches_native(group):
    assert all(group.run(_rank_collectives))
