"""The paper's three baseline engines and every step format the restore
reads, held against the JAX package.

A few MB of state (a bf16 matrix, fp32 vector and moment, an int32
vector, 0-d int32 and bf16 leaves, Python objects), made from a seed with
numpy, all on ``device="cpu"``. The snapshot engine's chunk files are cut
to 64 KiB + 12 B in both packages, so a tensor spans several files and a
ranged read crosses file boundaries.

* A step written by each engine of either package restores bit for bit
  through the other, and the JAX package's ``storage.cli verify`` passes
  on the port's steps; each package's sync and snapshot loaders read the
  other's files; the sync pickle bridge (``core/pickle_compat.py``) is
  held byte for byte against numpy's own pickle for every dtype.
* A snapshot step restores after its directory is moved;
  ``probe_step_complete`` agrees with the reference on complete and
  damaged legacy steps.
* ``datastates-old`` stages a tensor whole (one ``notify_staged``) and
  serializes objects up front; deltas and encoded routes are refused by
  the raw-only baselines with the reference's words.
* The dtype-converting restore gives the reference's bits (NaN, inf,
  subnormal and tie inputs included; its cast against ``ml_dtypes`` for
  every pair of dtypes); the XOR route still refuses it;
  ``throttle_mbps`` bounds a restore's and a serving load's time below.
* ``close`` joins every lane a manager started.
"""

import json
import os
import pickle
import shutil
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.core as J
import repro.core.baselines as JB
from repro.storage import cli as jcli
from repro.storage import manifest as jmanifest

import repro_torch.core as T
import repro_torch.core.baselines as TB
from repro_torch.convert import from_numpy_state
from repro_torch.core import dtypes, pickle_compat
from repro_torch.core.state_provider import TensorStateProvider
from repro_torch.core.tree import flatten_with_path
from repro_torch.serving.engine import load_params_for_serving
from repro_torch.storage import manifest as tmanifest

BF16 = ml_dtypes.bfloat16
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MODES = ["sync", "snapshot", "datastates-old", "datastates"]
#: the snapshot engines' chunk files in these tests: several a tensor,
#: boundaries inside rows
CHUNK_FILE_BYTES = (64 << 10) + 12


@pytest.fixture(autouse=True)
def _small_chunk_files(monkeypatch):
    for mod in (JB, TB):
        monkeypatch.setattr(mod.SnapshotThenFlushEngine, "CHUNK_FILE_BYTES",
                            CHUNK_FILE_BYTES)


def _state(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {
        "model": {"w": f32(256, 512).astype(BF16), "b": f32(513)},
        "optimizer": {"m": f32(300, 1024),
                      "idx": rng.integers(-2**31, 2**31 - 1, 1000,
                                          dtype=np.int32),
                      "count": np.array(7, np.int32),
                      "scale": np.array(1.5, BF16)},
        "meta": {"step": 7, "arch": "toy", "hp": {"lr": 1e-4}}}


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            a = a.view(torch.int16)
        return a.numpy().reshape(-1).view(np.uint8)
    return np.asarray(a).reshape(-1).view(np.uint8)


def _assert_same(got, want) -> None:
    g = flatten_with_path(got)[0]
    w = flatten_with_path(want)[0]
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_p, b) in zip(g, w):
        if isinstance(b, (np.ndarray, torch.Tensor)):
            assert tuple(a.shape) == tuple(b.shape), path
            assert (dtypes.of_tensor(a).name if isinstance(a, torch.Tensor)
                    else dtypes.host_name(a)) == \
                (dtypes.of_tensor(b).name if isinstance(b, torch.Tensor)
                 else dtypes.host_name(b)), path
            np.testing.assert_array_equal(_bits(a).reshape(-1),
                                          _bits(b).reshape(-1), err_msg=path)
        else:
            assert a == b, path


def _policy(mod, mode: str, **kw):
    return mod.CheckpointPolicy(engine=mod.EnginePolicy(
        mode=mode, host_cache_bytes=64 << 20, chunk_bytes=64 << 10), **kw)


def _save_port(root: str, mode: str, state: dict, step: int = 1):
    with T.CheckpointManager.from_policy(root, _policy(T, mode),
                                         device="cpu") as mgr:
        fut = mgr.save(step, from_numpy_state(state, "cpu"), blocking=True)
        assert not mgr.commit_errors
    return fut


def _jax(tree):
    """The reference saves device arrays (its host-resident path cannot
    byte-view an ``ml_dtypes`` array)."""
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(x) if isinstance(x, np.ndarray) else x, tree)


def _save_ref(root: str, mode: str, state: dict, step: int = 1):
    with J.CheckpointManager.from_policy(root, _policy(J, mode)) as mgr:
        fut = mgr.save(step, _jax(state), blocking=True)
        assert not mgr.commit_errors
    return fut


@pytest.mark.parametrize("mode", MODES)
def test_port_step_restores_through_repro(tmp_path, mode, capsys):
    state = _state()
    fut = _save_port(str(tmp_path), mode, state)
    files = os.listdir(fut.directory)
    assert jmanifest.detect_format(files) == {
        "sync": "sync", "snapshot": "snapshot"}.get(mode, "dsllm")
    with J.CheckpointManager.from_policy(str(tmp_path),
                                         _policy(J, mode)) as mgr:
        got = mgr.restore(_state(1), step=1)
    _assert_same(got, state)
    assert jcli.main(["--root", str(tmp_path), "verify"]) == 0
    assert "FAIL" not in capsys.readouterr().out


@pytest.mark.parametrize("mode", MODES)
def test_repro_step_restores_through_port(tmp_path, mode):
    state = _state()
    _save_ref(str(tmp_path), mode, state)
    template = from_numpy_state(_state(1), "cpu")
    with T.CheckpointManager.from_policy(str(tmp_path), _policy(T, mode),
                                         device="cpu") as mgr:
        assert mgr.repository.verify_step(1).ok
        got = mgr.restore(template, step=1)
    _assert_same(got, from_numpy_state(state, "cpu"))


def _flat_leaves(state) -> dict:
    return {f"state/{'/'.join(str(k) for k in p)}": a
            for p, a in flatten_with_path(state)[0]
            if isinstance(a, np.ndarray)}


def _strip(name: str) -> str:
    return name.split("@[", 1)[0]


@pytest.mark.parametrize("writer", ["port", "repro"])
def test_sync_loaders_read_each_others_files(tmp_path, writer):
    state = _state()
    save = _save_port if writer == "port" else _save_ref
    path = os.path.join(save(str(tmp_path), "sync", state).directory,
                        "rank00000.pkl")
    want = {_strip(k): v for k, v in _flat_leaves(
        {"model": state["model"], "optimizer": state["optimizer"]}).items()}
    for loader, host in ((TB.load_sync_rank, "port"),
                         (JB.load_sync_rank, "repro")):
        graph = loader(path)
        assert graph["__objects__"]["state/meta/arch"] == "toy"
        leaves = {_strip(k): v for k, v in graph.items()
                  if k != "__objects__"}
        assert sorted(leaves) == sorted(want)
        for k, rec in leaves.items():
            data = rec["data"]
            assert rec["dtype"] == dtypes.host_name(want[k])
            assert dtypes.host_name(data) == rec["dtype"], (host, k)
            assert data.shape == want[k].shape
            np.testing.assert_array_equal(_bits(data), _bits(want[k]))


@pytest.mark.parametrize("writer", ["port", "repro"])
def test_snapshot_loaders_read_each_others_files(tmp_path, writer):
    state = _state()
    save = _save_port if writer == "port" else _save_ref
    sdir = save(str(tmp_path), "snapshot", state).directory
    want = {_strip(k): v for k, v in _flat_leaves(
        {"model": state["model"], "optimizer": state["optimizer"]}).items()}
    port = {_strip(k): v for k, v in TB.load_snapshot_rank(sdir, 0).items()}
    ref = {_strip(k): v for k, v in JB.load_snapshot_rank(sdir, 0).items()}
    assert sorted(port) == sorted(ref) == sorted(want)
    for k, w in want.items():
        assert isinstance(port[k], torch.Tensor) \
            and port[k].device.type == "cpu"
        assert dtypes.of_tensor(port[k]).name == dtypes.host_name(w)
        assert tuple(port[k].shape) == w.shape == ref[k].shape
        np.testing.assert_array_equal(_bits(port[k]), _bits(w))
        np.testing.assert_array_equal(_bits(ref[k]), _bits(w))


def _edge_array(name: str) -> np.ndarray:
    """A few values of every kind for ``name``: NaNs of both signs, infs,
    subnormals, ties, extremes."""
    if name == "bool":
        return np.array([True, False, True])
    if name in ("float32", "float64", "float16", "bfloat16"):
        v = np.array([0.0, -0.0, 1.0, -2.5, np.inf, -np.inf, np.nan,
                      -np.nan, 1e-40, 3e38, 1.00390625, 1.01171875],
                     np.float32)
        return v.astype(BF16 if name == "bfloat16" else name)
    info = np.iinfo(name)
    return np.array([0, 1, -1 if info.min else 2, info.min, info.max],
                    dtype=name)


@pytest.mark.parametrize("name", sorted(dtypes.BY_NAME))
def test_pickle_bridge_both_directions(name):
    """Both directions bit for bit, a 0-d leaf too: the port's pickle of
    its host storage is numpy's pickle of the reference's array, byte for
    byte, and the port reads numpy's pickle back as its storage."""
    a = _edge_array(name)
    z = a[1:2].reshape(())
    ref_graph = {"state/x@[0:3]": {"data": a, "dtype": name},
                 "state/z@[]": {"data": z, "dtype": name},
                 "__objects__": {"state/meta/step": 3}}

    def storage(x):
        x = x.view(dtypes.lookup(name).storage)
        return x.view(dtypes.BF16_HOST) if name == "bfloat16" else x
    port_graph = {"state/x@[0:3]": {"data": storage(a), "dtype": name},
                  "state/z@[]": {"data": storage(z), "dtype": name},
                  "__objects__": {"state/meta/step": 3}}
    for arr in (a, z):
        assert pickle_compat.dumps(storage(arr)) == \
            pickle.dumps(arr, protocol=pickle.HIGHEST_PROTOCOL)
    want = pickle.dumps(ref_graph, protocol=pickle.HIGHEST_PROTOCOL)
    assert pickle.loads(pickle_compat.dumps(port_graph))["__objects__"] \
        == {"state/meta/step": 3}
    for key in ("state/x@[0:3]", "state/z@[]"):
        back = pickle.loads(pickle_compat.dumps(port_graph))[key]["data"]
        assert back.dtype == ref_graph[key]["data"].dtype
        assert back.shape == ref_graph[key]["data"].shape
        np.testing.assert_array_equal(_bits(back),
                                      _bits(ref_graph[key]["data"]))
        got = pickle_compat.loads(want)[key]["data"]
        assert dtypes.host_name(got) == name
        assert got.dtype == dtypes.lookup(name).storage
        assert got.shape == ref_graph[key]["data"].shape
        np.testing.assert_array_equal(_bits(got),
                                      _bits(ref_graph[key]["data"]))


@pytest.mark.parametrize("writer", ["port", "repro"])
def test_snapshot_step_restores_after_its_directory_moved(tmp_path, writer):
    state = _state()
    save = _save_port if writer == "port" else _save_ref
    src = save(str(tmp_path / "a"), "snapshot", state).directory
    dst = str(tmp_path / "moved")
    shutil.move(src, dst)
    want = from_numpy_state(state, "cpu")
    for threads in (1, 8):
        tree, stats = T.RestoreEngine("cpu", threads=threads).restore(
            dst, from_numpy_state(_state(1), "cpu"))
        _assert_same(tree, want)
        assert stats.bytes_read == sum(
            os.path.getsize(os.path.join(dst, n)) for n in os.listdir(dst)
            if not n.startswith("manifest_rank"))
    jtree, jstats = J.RestoreEngine(threads=1).restore(dst, _state(1))
    assert (stats.bytes_read, stats.n_ranges, stats.n_files) == \
        (jstats.bytes_read, jstats.n_ranges, jstats.n_files)


def _damage(sdir: str, how: str) -> None:
    names = sorted(os.listdir(sdir))
    if how == "complete":
        return
    if how == "moved chunk paths":
        return
    victim = [n for n in names if n.endswith(".bin")][-1] \
        if how.endswith("chunk") else \
        [n for n in names if n.endswith(".pkl")][0]
    path = os.path.join(sdir, victim)
    if how.startswith("missing"):
        os.remove(path)
    else:
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) // 2)


@pytest.mark.parametrize("mode,how,complete", [
    ("snapshot", "complete", True),
    ("snapshot", "moved chunk paths", True),
    ("snapshot", "truncated chunk", False),
    ("snapshot", "missing chunk", False),
    ("snapshot", "truncated manifest", False),
    ("sync", "complete", True),
    ("sync", "truncated pickle", False),
])
def test_probe_step_complete_agrees_with_reference(tmp_path, mode, how,
                                                   complete):
    sdir = _save_port(str(tmp_path / "a"), mode, _state()).directory
    if how == "moved chunk paths":
        moved = str(tmp_path / "b")
        shutil.move(sdir, moved)
        sdir = moved
    if how == "truncated manifest":
        path = os.path.join(sdir, "manifest_rank00000.pkl")
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) // 2)
    else:
        _damage(sdir, how)
    assert tmanifest.probe_step_complete(sdir) is complete
    assert jmanifest.probe_step_complete(sdir) is complete
    # the stat-fingerprint cache sees a later change
    if complete:
        for n in os.listdir(sdir):
            with open(os.path.join(sdir, n), "r+b") as f:
                f.truncate(0)
        assert not tmanifest.probe_step_complete(sdir)
        assert not jmanifest.probe_step_complete(sdir)


@pytest.mark.parametrize("mode,per_tensor", [("datastates-old", True),
                                             ("datastates", False)])
def test_datastates_old_stages_each_tensor_whole(tmp_path, monkeypatch,
                                                 mode, per_tensor):
    """One ``notify_staged`` a tensor, after its last chunk, and objects
    serialized in the blocking prologue; the paper's engine streams a
    tensor a chunk at a time and serializes objects lazily."""
    calls = {}
    real = TensorStateProvider.notify_staged

    def notify(self, nbytes_total):
        calls.setdefault(self.name, []).append(nbytes_total)
        return real(self, nbytes_total)
    monkeypatch.setattr(TensorStateProvider, "notify_staged", notify)
    state = _state()
    fut = _save_port(str(tmp_path), mode, state)
    sizes = {_strip(k): v.nbytes for k, v in _flat_leaves(
        {"model": state["model"], "optimizer": state["optimizer"]}).items()}
    assert sorted(_strip(k) for k in calls) == sorted(sizes)
    for name, seen in calls.items():
        assert seen[-1] == sizes[_strip(name)]
        if per_tensor:
            assert seen == [sizes[_strip(name)]]
    if per_tensor:
        assert fut.stats.serialize_s > 0
    else:
        assert max(len(s) for s in calls.values()) > 2
        assert fut.stats.serialize_s == 0


def _refusal(mod, device_kw, tmp, mode: str, what: str) -> str:
    state = _state() if mod is J else from_numpy_state(_state(), "cpu")
    if what == "delta policy":
        with pytest.raises(ValueError) as info:
            mod.CheckpointManager.from_policy(
                tmp, _policy(mod, mode, delta=mod.DeltaPolicy()),
                **device_kw)
        return str(info.value)
    if what == "delta save":
        eng = mod.ENGINES[mode](**device_kw)
        spec_mod = JB if mod is J else TB
        fut = mod.CheckpointFuture(1, tmp)
        with pytest.raises(ValueError) as info:
            eng.save(tmp, {}, {}, fut,
                     delta=spec_mod.DeltaSaveSpec(step=1, base_step=None,
                                                  keyframe=True))
        eng.close()
        return str(info.value)
    reg = mod.StateProviderRegistry([mod.ProviderRule(
        provider=what, domain="optimizer", dtype="float32"),
        mod.ProviderRule(provider="auto")])
    with mod.CheckpointManager.from_policy(
            tmp, _policy(mod, mode, providers=reg), **device_kw) as mgr:
        with pytest.raises(ValueError) as info:
            mgr.save(1, state)
    return str(info.value)


@pytest.mark.parametrize("mode", ["sync", "snapshot"])
@pytest.mark.parametrize("what", ["delta policy", "delta save",
                                  "quantized", "delta"])
def test_raw_baselines_refuse_deltas_and_encoded_routes(tmp_path, mode,
                                                        what):
    want = _refusal(J, {}, str(tmp_path / "j"), mode, what)
    got = _refusal(T, {"device": "cpu"}, str(tmp_path / "t"), mode, what)
    assert got == want
    assert ("DataMovementEngine" in got) or ("cannot encode deltas" in got)


@pytest.mark.parametrize("mode", ["datastates", "snapshot", "sync"])
@pytest.mark.parametrize("threads", [1, 8])
def test_dtype_converting_restore_matches_reference(tmp_path, mode,
                                                    threads):
    """The reference's ``test_dtype_converting_restore_casts_values`` as
    a parity test: a float32 leaf restored as bfloat16, float16 and
    int32, and a bfloat16 leaf as float32 and float16, give the JAX
    package's bits — NaN of both signs, inf, subnormal and tie inputs
    included — through ranged reads (native, snapshot) and the pickled
    graph (sync)."""
    edge = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 1e-40,
                     -1e-45, 1.00390625, 1.01171875, 3.4e38, 65520.0,
                     -70000.5, 2.5, -3.5], np.float32)
    nan = np.array([0x7F800001, 0xFFC00001, 0x7FFFFFFF], np.uint32) \
        .view(np.float32)
    w = np.concatenate([np.linspace(-4.0, 4.0, 64, dtype=np.float32),
                        edge, nan])
    hb = np.array([0x7F81, 0xFF81, 0x7FC0, 0xFFFF, 0x0001, 0x8001, 0x7F80,
                   0x477F, 0x4780, 0x3F80], np.uint16).view(BF16)
    state = {"w": w, "h": hb, "meta": {"step": 1}}
    with J.CheckpointManager.from_policy(str(tmp_path),
                                         _policy(J, mode)) as mgr:
        sdir = mgr.save(1, _jax(state), blocking=True).directory
    for w_dt, h_dt in ((BF16, np.float32), (np.float16, np.float16),
                       (np.int32, np.float32)):
        jt = {"w": np.empty(w.shape, w_dt), "h": np.empty(hb.shape, h_dt),
              "meta": {"step": 0}}
        with np.errstate(invalid="ignore", over="ignore"):
            want, _ = J.RestoreEngine(threads=threads).restore(sdir, jt)
        tt = {k: torch.empty(v.shape, dtype=dtypes.lookup(
                  dtypes.host_name(v)).torch) if isinstance(v, np.ndarray)
              else v for k, v in jt.items()}
        with np.errstate(invalid="ignore", over="ignore"):
            got, _ = T.RestoreEngine("cpu", threads=threads).restore(
                sdir, tt)
        _assert_same(got, from_numpy_state(want, "cpu"))


def test_xor_route_still_refuses_a_converting_restore(tmp_path):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((64, 64)).astype(np.float32)
    pol = J.CheckpointPolicy(engine=J.EnginePolicy(host_cache_bytes=64 << 20),
                             delta=J.DeltaPolicy(keyframe_every=3))
    with J.CheckpointManager.from_policy(str(tmp_path), pol) as mgr:
        mgr.save(1, {"w": jnp.asarray(w)}, blocking=True)
        mgr.save(2, {"w": jnp.asarray(w + 1)}, blocking=True)
        with pytest.raises(J.RestoreError, match="not defined for XOR"):
            mgr.restore({"w": np.empty((64, 64), BF16)}, step=2)
    tpol = T.CheckpointPolicy(engine=T.EnginePolicy(host_cache_bytes=64 << 20),
                              delta=T.DeltaPolicy(keyframe_every=3))
    with T.CheckpointManager.from_policy(str(tmp_path), tpol,
                                         device="cpu") as mgr:
        with pytest.raises(T.RestoreError, match="not defined for XOR"):
            mgr.restore({"w": torch.empty(64, 64, dtype=torch.bfloat16)},
                        step=2)
        got = mgr.restore({"w": torch.empty(64, 64)}, step=2)
    assert torch.equal(got["w"], torch.from_numpy(w + 1))


#: a low per-stream rate: the test's ~0.3 MB take at least ~0.3 s
THROTTLE_MBPS = 1.0


@pytest.mark.parametrize("mode", ["datastates", "snapshot"])
@pytest.mark.parametrize("convert", [False, True])
def test_throttled_restore_takes_at_least_bytes_over_rate(tmp_path, mode,
                                                          convert):
    """One stream (``threads=1``) at ``throttle_mbps``: ranged reads, and
    the scratch reads of a converting restore, end no sooner than their
    bytes over the rate."""
    rng = np.random.default_rng(0)
    state = {"w": rng.standard_normal((300, 256)).astype(np.float32)}
    fut = _save_port(str(tmp_path), mode, state)
    tmpl = {"w": torch.empty(300, 256, dtype=torch.bfloat16 if convert
                             else torch.float32)}
    t0 = time.perf_counter()
    got, stats = T.RestoreEngine("cpu", threads=1,
                                 throttle_mbps=THROTTLE_MBPS).restore(
        fut.directory, tmpl)
    secs = time.perf_counter() - t0
    assert stats.bytes_read >= state["w"].nbytes
    assert secs >= stats.bytes_read / (THROTTLE_MBPS * 1e6)
    assert secs < 5
    want = torch.from_numpy(state["w"])
    assert torch.equal(got["w"], want.to(tmpl["w"].dtype))


def test_throttled_serving_load_takes_at_least_bytes_over_rate(tmp_path):
    rng = np.random.default_rng(0)
    state = {"model": {"w": rng.standard_normal((300, 256))
                       .astype(np.float32)},
             "optimizer": {"m": rng.standard_normal((300, 256))
                           .astype(np.float32)}}
    _save_port(str(tmp_path), "datastates", state)
    t0 = time.perf_counter()
    params, stats = load_params_for_serving(
        str(tmp_path), {"w": torch.empty(300, 256)}, threads=1,
        throttle_mbps=THROTTLE_MBPS)
    secs = time.perf_counter() - t0
    assert stats.bytes_read == state["model"]["w"].nbytes
    assert secs >= stats.bytes_read / (THROTTLE_MBPS * 1e6)
    assert torch.equal(params["w"], torch.from_numpy(state["model"]["w"]))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
def test_engines_on_the_card(tmp_path, mode):
    """Each engine saves CUDA tensors (a blocking pageable copy for the
    snapshot, the pickled graph for sync, the pinned cache for the other
    two) and restores them onto the card bit for bit; the JAX package
    reads the step too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    state = from_numpy_state(_state(), "cuda")
    with T.CheckpointManager.from_policy(str(tmp_path), _policy(T, mode),
                                         device="cuda") as mgr:
        mgr.save(1, state, blocking=True)
        assert not mgr.commit_errors and mgr.repository.verify_step(1).ok
        got = mgr.restore(from_numpy_state(_state(1), "cuda"), step=1)
    for (_p, a), (_q, b) in zip(flatten_with_path(got)[0],
                                flatten_with_path(state)[0]):
        if isinstance(b, torch.Tensor):
            assert a.is_cuda and a.dtype == b.dtype and torch.equal(a, b)
    with J.CheckpointManager.from_policy(str(tmp_path),
                                         _policy(J, mode)) as mgr:
        _assert_same(mgr.restore(_state(1), step=1), _state())


@pytest.mark.parametrize("mode", MODES)
def test_close_joins_every_lane(tmp_path, mode):
    """Every thread a manager and its engine start has ended when
    ``close`` returns. A lane that ran PyTorch code and is still alive
    when the interpreter finalizes aborts the process ("terminate called
    without an active exception"), as the launcher's did under load."""
    before = set(threading.enumerate())
    mgr = T.CheckpointManager.from_policy(str(tmp_path), _policy(T, mode),
                                          device="cpu")
    mgr.save(1, from_numpy_state(_state(), "cpu"), blocking=True)
    started = set(threading.enumerate()) - before
    assert started  # at least the committer
    mgr.close()
    assert not [t.name for t in started if t.is_alive()]



_NO_ML_DTYPES = """
import json, sys
for m in ("jax", "repro", "ml_dtypes"):
    sys.modules[m] = None
import torch
import repro_torch.core as T
from repro_torch.core import dtypes
from repro_torch.core.tree import flatten_with_path, path_str
from repro_torch.storage.manifest import probe_step_complete
root, spec = sys.argv[1], json.loads(sys.argv[2])
out = {}
for mode in ("sync", "snapshot"):
    tmpl = {}
    for path, (shape, name) in spec.items():
        node = tmpl
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = torch.empty(shape, dtype=dtypes.lookup(name).torch)
    with T.CheckpointManager.from_policy(f"{root}/{mode}",
                                         device="cpu") as mgr:
        assert probe_step_complete(mgr.repository.step_dir(1)), mode
        got = mgr.restore(tmpl, step=1)
    for p, t in flatten_with_path(got)[0]:
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        out[f"{mode}:{path_str(p)}"] = t.reshape(-1).view(torch.uint8) \
            .numpy().tobytes().hex()
print(json.dumps(out))
"""


def test_port_reads_repro_steps_without_ml_dtypes(tmp_path):
    """On a host without ``ml_dtypes`` (the card's) the port restores the
    JAX package's sync and snapshot steps bit for bit, bfloat16 leaves
    included, and probes them complete: the pickle bridge never imports
    it."""
    state = _state()
    for mode in ("sync", "snapshot"):
        _save_ref(str(tmp_path / mode), mode, state)
    leaves = {k[len("state/"):]: v for k, v in _flat_leaves(state).items()}
    spec = {k: [list(v.shape), dtypes.host_name(v)]
            for k, v in leaves.items()}
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run(
        [sys.executable, "-c", _NO_ML_DTYPES, str(tmp_path),
         json.dumps(spec)], env=env, capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {f"{mode}:{k}": _bits(v).tobytes().hex()
                   for mode in ("sync", "snapshot")
                   for k, v in leaves.items()}


def _every_value(name: str) -> np.ndarray:
    """Every bit pattern of a 16-bit float, a seeded spread of the wider
    types' patterns with their edge values, the integers' extremes."""
    if name in ("bfloat16", "float16"):
        words = np.arange(1 << 16, dtype=np.uint16)
        return words.view(BF16 if name == "bfloat16" else np.float16)
    rng = np.random.default_rng(len(name))
    if name in ("float32", "float64"):
        u = np.dtype(f"u{np.dtype(name).itemsize}")
        bits = rng.integers(0, np.iinfo(u).max, 1 << 16, dtype=u,
                            endpoint=True)
        return np.concatenate([bits.view(name), _edge_array(name)])
    return _edge_array(name) if name == "bool" else np.concatenate(
        [_edge_array(name), rng.integers(np.iinfo(name).min,
                                         np.iinfo(name).max, 1 << 12,
                                         dtype=name)])


@pytest.mark.parametrize("src", sorted(dtypes.BY_NAME))
def test_cast_host_matches_ml_dtypes(src):
    """The converting restore's cast gives numpy's bits with
    ``ml_dtypes``, from ``src`` to every dtype of the table: bfloat16
    through float32 both ways, NaNs as ``ml_dtypes`` makes them."""
    x = _every_value(src)
    stored = x.view(np.uint16) if src == "bfloat16" else x
    for dst in sorted(dtypes.BY_NAME):
        with np.errstate(all="ignore"):
            want = x.astype(BF16 if dst == "bfloat16" else dst)
            got = dtypes.cast_host(stored, src, dst)
        assert got.dtype == dtypes.lookup(dst).storage, (src, dst)
        np.testing.assert_array_equal(_bits(got), _bits(want),
                                      err_msg=f"{src} -> {dst}")
