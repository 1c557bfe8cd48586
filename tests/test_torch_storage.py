"""The port's tiered repository held against the JAX package's.

* Backends: put, get, list, ``get_range``, ``put_file`` and ``get_file``
  on ``LocalBackend``, ``MemoryBackend`` and ``ObjectStoreBackend`` (cases
  of parametrised tests); multipart visibility; the memory tier's
  capacity; the object store's shared pipe held to ``repro``'s modelled
  time floor.
* Retention and GC: ``RetentionPolicy.retained`` equals ``repro``'s over
  drawn step lists; the same saves (a delta chain, a pin, a step
  mid-cascade) give the same ``GCReport`` in both packages, with every
  kept step's chain closure kept.
* Cascade and re-hydration across packages, both ways, bit for bit
  against the saved inputs: the port cascades a K, delta, delta chain to
  a tier and ``repro`` re-hydrates it on an empty root, and the reverse. A
  tier without the catalog object hides the step; a flipped bit in a
  tier's data object fails ``admit_fetched_step`` and the next tier
  serves.
* The CLI: the same commands on the same repository print the same
  lines and exit codes through ``repro.storage.cli.main`` and
  ``repro_torch.storage.cli.main`` (timings masked).
* A smoke-size ``Trainer`` saving to a ``MemoryBackend`` tier under
  ``keep_last_n=1``: local GC keeps the chain closure, a fresh root
  resumes from the tier bit-exactly and the next loss is bit-equal. A
  world-2 thread-rank step cascades to a memory tier.

Everything runs with ``device="cpu"`` (``--device cpu`` for the CLI).
"""

import os
import re
import shutil
import threading
import time

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

import repro.core as J  # noqa: E402
import repro.storage as JS  # noqa: E402
from repro.storage import cli as jcli  # noqa: E402

import repro_torch.core as T  # noqa: E402
import repro_torch.storage as S  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.convert import from_numpy_state, to_numpy_state  # noqa: E402
from repro_torch.core.tree import leaves  # noqa: E402
from repro_torch.storage import cli as tcli  # noqa: E402
from repro_torch.storage.repository import catalog_key, data_key  # noqa: E402
from repro_torch.training.loop import Trainer  # noqa: E402

PKGS = {"repro": (J, JS), "repro_torch": (T, S)}


# ---------------------------------------------------------------- backends
def _backend(kind, tmp_path):
    if kind == "local":
        return S.LocalBackend(str(tmp_path / "tier"))
    if kind == "memory":
        return S.MemoryBackend()
    return S.ObjectStoreBackend(part_bytes=4096)


KINDS = ["local", "memory", "object"]


@pytest.mark.parametrize("kind", KINDS)
def test_backend_put_get_list_delete(tmp_path, kind):
    be = _backend(kind, tmp_path)
    be.put("a/x", b"hello")
    be.put("a/y", b"")
    be.put("b/z", b"world!")
    assert be.get("a/x") == b"hello" and be.get("a/y") == b""
    assert be.list() == ["a/x", "a/y", "b/z"]
    assert be.list("a/") == ["a/x", "a/y"]
    assert be.exists("b/z") and be.size("b/z") == 6
    be.put("a/x", b"replaced")
    assert be.get("a/x") == b"replaced"
    be.delete("a/x")
    be.delete("a/x")  # missing keys are a no-op
    assert not be.exists("a/x") and be.list("a/") == ["a/y"]
    with pytest.raises(S.BackendError, match="no such key"):
        be.get("a/x")


@pytest.mark.parametrize("kind", KINDS)
def test_backend_get_range_is_byte_accurate(tmp_path, kind):
    be = _backend(kind, tmp_path)
    blob = bytes(range(256)) * 40
    be.put("k", blob)
    for off, nb in ((0, 10), (100, 1000), (10000, 500), (10240, 8),
                    (0, len(blob))):
        assert be.get_range("k", off, nb) == blob[off:off + nb]
    with pytest.raises(S.BackendError):
        be.get_range("missing", 0, 1)
    if kind == "object":
        before = be.stats["bytes_out"]
        be.get_range("k", 5, 77)
        assert be.stats["bytes_out"] - before == 77  # only the slice moved


@pytest.mark.parametrize("kind", KINDS)
def test_backend_file_helpers_round_trip(tmp_path, kind):
    be = _backend(kind, tmp_path)
    src = tmp_path / "src.bin"
    payload = np.random.default_rng(1).integers(
        0, 256, 3 * 4096 + 17, dtype=np.uint8).tobytes()
    src.write_bytes(payload)
    assert be.put_file("d/file.bin", str(src)) == len(payload)
    assert be.get("d/file.bin") == payload
    dst = tmp_path / "out" / "copy.bin"
    assert be.get_file("d/file.bin", str(dst)) == len(payload)
    assert dst.read_bytes() == payload
    assert not [n for n in os.listdir(dst.parent) if "tmp" in n]
    with pytest.raises(S.BackendError):
        be.get_file("d/none", str(tmp_path / "none"))
    if kind == "object":  # 4 KiB parts: the upload went multipart
        assert be.stats["n_multipart"] == 1


def test_object_store_multipart_visible_only_when_complete():
    be = S.ObjectStoreBackend()
    up = be.initiate_multipart("big")
    be.upload_part(up, 1, b"world")
    be.upload_part(up, 0, b"hello ")
    assert not be.exists("big") and be.list() == []
    be.complete_multipart(up)
    assert be.get("big") == b"hello world"
    aborted = be.initiate_multipart("gone")
    be.upload_part(aborted, 0, b"x")
    be.abort_multipart(aborted)
    assert not be.exists("gone")
    with pytest.raises(S.BackendError, match="unknown upload"):
        be.complete_multipart(aborted)
    with pytest.raises(S.BackendError, match="no parts"):
        be.complete_multipart(be.initiate_multipart("empty"))


def test_memory_backend_capacity():
    mem = S.MemoryBackend(capacity_bytes=1500)
    mem.put("a", b"a" * 700)
    with pytest.raises(S.BackendError, match="full"):
        mem.put("b", b"b" * 1000)
    mem.put("b", b"b" * 700)
    mem.put("b", b"c" * 800)  # a replacement counts its own size once
    assert mem.used_bytes() == 1500
    assert not mem.exists("c")


def test_object_store_shared_pipe_holds_the_modelled_floor():
    """Two readers of 100 KB through a 1 MB/s pipe share it: together no
    sooner than 0.2 s (the JAX package's floor, ``>= 0.18`` s)."""
    for mod in (JS, S):
        be = mod.ObjectStoreBackend()
        be.put("blob", os.urandom(100_000))
        be.bandwidth_mbps = 1.0
        start = threading.Barrier(2)

        def read():
            start.wait(timeout=30)
            be.get("blob")

        threads = [threading.Thread(target=read) for _ in range(2)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        wall = time.perf_counter() - t0
        assert not any(t.is_alive() for t in threads)
        assert wall >= 0.18, (mod.__name__, wall)
        assert be.stats["bytes_out"] == 200_000


# --------------------------------------------------------------- retention
@settings(max_examples=60, deadline=None)
@given(steps=st.lists(st.integers(0, 500), max_size=30, unique=True),
       keep_last_n=st.one_of(st.none(), st.integers(0, 8)),
       keep_every_k=st.one_of(st.none(), st.integers(0, 50)))
def test_retention_policy_matches_reference(steps, keep_last_n,
                                            keep_every_k):
    want = JS.RetentionPolicy(keep_last_n=keep_last_n,
                              keep_every_k=keep_every_k).retained(steps)
    got = S.RetentionPolicy(keep_last_n=keep_last_n,
                            keep_every_k=keep_every_k).retained(steps)
    assert got == want


# ------------------------------------------------------------------ states
def _states(n_steps: int, seed: int = 0):
    """{step: numpy state}: fp32 and bf16 model leaves changing in part
    each step, a 0-d int32, and Python objects."""
    rng = np.random.default_rng(seed)
    w0 = rng.standard_normal(8192).astype(np.float32)
    w1 = rng.standard_normal((64, 64)).astype(ml_dtypes.bfloat16)
    out = {}
    for step in range(1, n_steps + 1):
        w0 = w0.copy()
        hit = rng.random(w0.shape) < 0.3
        w0[hit] += np.float32(1e-3)
        w1 = (w1.astype(np.float32) + np.float32(0.25)).astype(
            ml_dtypes.bfloat16)
        out[step] = {"model": {"w0": w0, "w1": w1},
                     "count": np.array(step, np.int32),
                     "meta": {"step": step, "tag": "t"}}
    return out


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def _assert_state(got, want):
    np.testing.assert_array_equal(_bits(got["model"]["w0"]),
                                  _bits(want["model"]["w0"]))
    np.testing.assert_array_equal(_bits(got["model"]["w1"]),
                                  _bits(want["model"]["w1"]))
    np.testing.assert_array_equal(np.asarray(got["count"]), want["count"])
    assert got["meta"] == want["meta"]


def _policy(pkg, tiers=(), keyframe_every=3, retention=None):
    mod, _st = PKGS[pkg]
    return mod.CheckpointPolicy(
        engine=mod.EnginePolicy(host_cache_bytes=16 << 20, flush_threads=1),
        storage=mod.StoragePolicy(tiers=tiers, retention=retention),
        delta=mod.DeltaPolicy(keyframe_every=keyframe_every))


def _save(pkg, root, states, steps, tiers=(), keyframe_every=3):
    """Save ``steps`` of ``states`` through ``pkg``'s manager and wait for
    every commit and cascade."""
    mod, _st = PKGS[pkg]
    kw = {"device": "cpu"} if pkg == "repro_torch" else {}
    mgr = mod.CheckpointManager.from_policy(
        str(root), _policy(pkg, tiers, keyframe_every), **kw)
    try:
        for step in steps:
            tree = states[step]
            if pkg == "repro":
                tree = {**tree, "model": {k: jnp.asarray(v) for k, v in
                                          tree["model"].items()},
                        "count": jnp.asarray(tree["count"])}
            else:
                tree = from_numpy_state(tree, "cpu")
            mgr.save(step, tree)
        mgr.wait_for_persist()
        mgr.wait_for_commit()
        mgr.repository.wait_cascaded()
        assert not mgr.commit_errors
        assert not mgr.repository.cascade_errors
    finally:
        mgr.close()


def _restore(pkg, root, tiers, template_state, step=None):
    mod, _st = PKGS[pkg]
    if pkg == "repro":
        tpl = {**template_state,
               "model": {k: jnp.asarray(v)
                         for k, v in template_state["model"].items()},
               "count": jnp.asarray(template_state["count"])}
        mgr = mod.CheckpointManager.from_policy(str(root),
                                                _policy(pkg, tiers))
    else:
        tpl = from_numpy_state(template_state, "cpu")
        mgr = mod.CheckpointManager.from_policy(
            str(root), _policy(pkg, tiers), device="cpu")
    try:
        out = mgr.restore(tpl, step=step)
        restored = mgr.last_restored_step
    finally:
        mgr.close()
    if pkg == "repro":
        out = {**out, "model": {k: np.asarray(v)
                                for k, v in out["model"].items()},
               "count": np.asarray(out["count"])}
    else:
        out = to_numpy_state(out)
        out["model"]["w1"] = out["model"]["w1"].view(ml_dtypes.bfloat16)
    return out, restored


# ---------------------------------------------------- cascade, both ways
@pytest.mark.parametrize("writer,reader", [("repro_torch", "repro"),
                                           ("repro", "repro_torch")])
def test_cascade_and_rehydrate_across_packages(tmp_path, writer, reader):
    """``writer`` saves K, delta, delta and cascades the chain to a local
    tier; ``reader`` re-hydrates the newest step on an empty root from
    the same tier and restores it bit for bit."""
    states = _states(3)
    tier_dir = str(tmp_path / "tier")
    wtier = PKGS[writer][1].Tier("t", PKGS[writer][1].LocalBackend(tier_dir))
    _save(writer, tmp_path / "train", states, (1, 2, 3), tiers=(wtier,))
    keys = PKGS[writer][1].LocalBackend(tier_dir).list()
    assert keys == sorted([catalog_key(s) for s in (1, 2, 3)]
                          + [data_key(s, "rank00000.dsllm")
                             for s in (1, 2, 3)])
    rtier = PKGS[reader][1].Tier("t", PKGS[reader][1].LocalBackend(tier_dir))
    out, step = _restore(reader, tmp_path / "fresh", (rtier,), states[1])
    assert step == 3
    _assert_state(out, states[3])
    # the chain landed on the fresh root, admitted into its catalog
    assert JS.CheckpointRepository(str(tmp_path / "fresh")).local_steps() \
        == [1, 2, 3]
    out, _ = _restore(reader, tmp_path / "fresh2", (rtier,), states[1],
                      step=2)
    _assert_state(out, states[2])


def test_cascade_ships_the_catalog_object_last(tmp_path):
    """Every data object of a step is on the tier before its catalog
    object, and a chain's base before the delta that needs it."""
    order = []

    class Recording(S.ObjectStoreBackend):
        def put(self, key, data):
            super().put(key, data)
            order.append(key)

        def complete_multipart(self, upload_id):
            key = self._uploads[upload_id][0]
            super().complete_multipart(upload_id)
            order.append(key)

    states = _states(3)
    root = tmp_path / "train"
    _save("repro_torch", root, states, (1, 2, 3))
    repo = S.CheckpointRepository(
        str(root), [S.Tier("t", Recording(part_bytes=8192))], device="cpu",
        auto_cascade=False)
    repo.cascade_step(3)  # the whole chain ships from the newest step
    assert order == [data_key(1, "rank00000.dsllm"), catalog_key(1),
                     data_key(2, "rank00000.dsllm"), catalog_key(2),
                     data_key(3, "rank00000.dsllm"), catalog_key(3)]
    assert [e.step for e in repo.cascade_log] == [1, 2, 3]
    assert sum(e.nbytes for e in repo.cascade_log) == sum(
        repo.manifest(s).total_bytes for s in (1, 2, 3))
    repo.cascade_step(3)  # identical manifests: nothing ships again
    assert len(order) == 6
    repo.close()


def test_tier_without_catalog_object_hides_the_step(tmp_path):
    states = _states(3)
    tier_dir = str(tmp_path / "tier")
    _save("repro_torch", tmp_path / "train", states, (1, 2, 3),
          tiers=(S.Tier("t", S.LocalBackend(tier_dir)),))
    S.LocalBackend(tier_dir).delete(catalog_key(3))
    for mod in (JS, S):
        kw = {"device": "cpu"} if mod is S else {}
        repo = mod.CheckpointRepository(
            str(tmp_path / f"fresh-{mod.__name__}"),
            [mod.Tier("t", mod.LocalBackend(tier_dir))],
            auto_cascade=False, **kw)
        assert repo.steps() == [1, 2]
        with pytest.raises(FileNotFoundError):
            repo.resolve_for_restore(3)
        repo.close()


def test_flipped_bit_on_a_tier_fails_admission_and_the_next_tier_serves(
        tmp_path):
    states = _states(1)
    bad_dir = str(tmp_path / "bad")
    good = S.MemoryBackend()
    _save("repro_torch", tmp_path / "train", states, (1,),
          tiers=(S.Tier("bad", S.LocalBackend(bad_dir)),
                 S.Tier("good", good)))
    path = os.path.join(bad_dir, data_key(1, "rank00000.dsllm"))
    with open(path, "r+b") as f:
        f.seek(4096)
        b = f.read(1)
        f.seek(4096)
        f.write(bytes([b[0] ^ 0x10]))
    only_bad = S.CheckpointRepository(
        str(tmp_path / "fresh0"), [S.Tier("bad", S.LocalBackend(bad_dir))],
        device="cpu", auto_cascade=False)
    with pytest.raises(S.BackendError, match="every tier") as exc:
        only_bad.resolve_for_restore(1)
    assert "checksum mismatch" in str(exc.value.__cause__)
    assert only_bad.local_steps() == []  # nothing unverified published
    only_bad.close()
    out, step = _restore("repro_torch", tmp_path / "fresh1",
                         (S.Tier("bad", S.LocalBackend(bad_dir)),
                          S.Tier("good", good)), states[1])
    assert step == 1
    _assert_state(out, states[1])


# ---------------------------------------------------------------------- GC
def test_gc_matches_reference_and_keeps_chain_closures(tmp_path):
    """Steps 1-5 (K, delta, K, delta, K), all cascaded; step 2 pinned,
    step 3 still cascading: both packages delete the same local steps
    and the same tier steps, and every kept delta keeps its keyframe."""
    states = _states(5)
    reports = {}
    for pkg in PKGS:
        mod, smod = PKGS[pkg]
        root = tmp_path / pkg / "train"
        tier_dir = str(tmp_path / pkg / "tier")
        _save(pkg, root, states, (1, 2, 3, 4, 5), keyframe_every=2,
              tiers=(smod.Tier("t", smod.LocalBackend(tier_dir)),))
        kw = {"device": "cpu"} if pkg == "repro_torch" else {}
        repo = smod.CheckpointRepository(
            str(root), [smod.Tier("t", smod.LocalBackend(tier_dir),
                                  smod.RetentionPolicy(keep_last_n=1))],
            auto_cascade=False, auto_gc=False, **kw)
        assert repo.chain_steps(4) == [3, 4] and repo.chain_steps(2) == [1, 2]
        repo.pin(2)
        repo._mid_cascade.add(3)
        policy = smod.RetentionPolicy(keep_last_n=1)
        dry = repo.gc(retention=policy, dry_run=True)
        assert repo.local_steps() == [1, 2, 3, 4, 5]  # a dry run deletes
        done = repo.gc(retention=policy)
        reports[pkg] = (dry, done, repo.local_steps(),
                        repo.tier_steps(repo.remote_tiers[0]),
                        sorted(repo.pins()))
        for s in repo.local_steps():
            assert set(repo.chain_steps(s)) <= set(repo.local_steps())
        repo.close()
    (jd, jr, jl, jt, jp), (td, tr, tl, tt, tp) = reports["repro"], \
        reports["repro_torch"]
    assert td.deleted_steps == jd.deleted_steps == [4]
    assert tr.deleted_steps == jr.deleted_steps == [4]
    assert td.remote_deleted == jd.remote_deleted == {"t": [4]}
    assert tr.remote_deleted == jr.remote_deleted
    assert td.dry_run and not tr.dry_run
    assert tr.bytes_freed == td.bytes_freed > 0
    assert tl == jl == [1, 2, 3, 5] and tt == jt == [1, 2, 3, 5]
    assert tp == jp == [2]


def test_gc_orphans_match_reference(tmp_path):
    """A crash victim (marker and data, no catalog entry) is an orphan in
    both packages; ``gc(include_orphans=True)`` removes it unless it is
    younger than the grace window."""
    states = _states(2)
    for pkg in PKGS:
        mod, smod = PKGS[pkg]
        root = tmp_path / pkg
        _save(pkg, root, states, (1,))
        shutil.copytree(root / "global_step1", root / "global_step7")
        (root / ".catalog" / "inflight-000000000007").write_text(
            str(time.time()))
        kw = {"device": "cpu"} if pkg == "repro_torch" else {}
        repo = smod.CheckpointRepository(str(root), auto_cascade=False, **kw)
        assert repo.orphans() == [7] and repo.steps() == [1]
        assert repo.gc(include_orphans=True,
                       orphan_grace_s=900).deleted_orphans == []
        rep = repo.gc(include_orphans=True)
        assert rep.deleted_orphans == [7] and rep.deleted_steps == []
        assert not (root / "global_step7").exists()
        repo.close()


def test_resave_retracts_dependents_on_every_tier(tmp_path):
    """Re-saving a chain's keyframe retracts the committed deltas built
    on it, locally and on the tier, as the JAX package does."""
    states = _states(3)
    mem = S.MemoryBackend()
    root = tmp_path / "train"
    _save("repro_torch", root, states, (1, 2, 3), tiers=(S.Tier("m", mem),))
    repo = S.CheckpointRepository(str(root), [S.Tier("m", mem)],
                                  device="cpu", auto_cascade=False)
    repo.begin_step(1)
    assert repo.local_steps() == [] and repo.tier_steps(repo.remote_tiers[0]) \
        == [1]
    assert sorted(repo.orphans()) == [2, 3]
    repo.abort_step(1)
    repo.close()


# --------------------------------------------------------------------- CLI
def _mask(text: str) -> str:
    return re.sub(r"\(\d+\.\d ms\)", "(T ms)", text)


@pytest.fixture(scope="module")
def cli_repo(tmp_path_factory):
    """A port repository: K, delta, K (steps 1-3), an orphan (step 9) and
    a fleet ledger for step 3."""
    from repro_torch.fleet import FleetFabric
    root = tmp_path_factory.mktemp("cli") / "repo"
    states = _states(3)
    _save("repro_torch", root, states, (1, 2, 3), keyframe_every=2)
    shutil.copytree(root / "global_step1", root / "global_step9")
    (root / ".catalog" / "inflight-000000000009").write_text("0")
    fabric = FleetFabric(device="cpu")
    fabric._step_stats[3] = {"remote_bytes": 5 << 20, "peer_bytes": 15 << 20,
                             "cache_hits": 3, "replicas": 4, "delta": False}
    fabric.persist(S.CheckpointRepository(str(root), device="cpu"))
    return root


CLI_CASES = {
    "ls": [["ls"]],
    "verify": [["verify"], ["verify", "--step", "2"],
               ["verify", "--fast"], ["verify", "--step", "42"]],
    "pin": [["pin", "1"], ["ls"], ["gc", "--keep-last", "1", "--dry-run"]],
    "unpin": [["pin", "1"], ["unpin", "1"], ["ls"]],
    "gc-dry-run": [["gc", "--keep-last", "1", "--dry-run"],
                   ["gc", "--keep-last", "1", "--orphans", "--dry-run",
                    "--orphan-grace", "0"], ["ls"]],
    "stats": [["stats"], ["stats", "--step", "2"], ["stats", "--step", "8"]],
    "stats-fleet": [["stats", "--fleet"], ["stats", "--fleet", "--step", "3"],
                    ["stats", "--fleet", "--step", "1"]],
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_matches_reference(tmp_path, capsys, cli_repo, case):
    outs = {}
    for pkg, main, extra in (("repro", jcli.main, []),
                             ("repro_torch", tcli.main,
                              ["--device", "cpu"])):
        root = tmp_path / pkg
        shutil.copytree(cli_repo, root)
        got = []
        for argv in CLI_CASES[case]:
            capsys.readouterr()
            rc = main(["--root", str(root)] + extra + argv)
            got.append((rc, _mask(capsys.readouterr().out)))
        outs[pkg] = got
    assert outs["repro_torch"] == outs["repro"]
    assert all(out for _rc, out in outs["repro"])


def test_cli_refuses_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(["--root", str(tmp_path), "ls"])


# ----------------------------------------------------- manager and trainer
def test_trainer_resumes_from_a_memory_tier_on_a_fresh_root(tmp_path):
    """A smoke-size trainer saves K, delta, delta to a memory tier under
    ``keep_last_n=1``: local GC keeps the newest step's chain. A fresh
    root resumes from the tier bit for bit, and the next loss equals the
    uninterrupted trainer's bit for bit."""
    cfg = smoke_variant(get_config("llama3.2-1b"))
    mem = S.MemoryBackend()
    policy = T.CheckpointPolicy(
        engine=T.EnginePolicy(host_cache_bytes=64 << 20, flush_threads=2),
        storage=T.StoragePolicy(tiers=(S.Tier("mem", mem),),
                                retention=S.RetentionPolicy(keep_last_n=1)),
        delta=T.DeltaPolicy(keyframe_every=3))
    mgr = T.CheckpointManager.from_policy(str(tmp_path / "a"), policy,
                                          device="cpu")
    tr = Trainer(cfg, batch=2, seq_len=16, manager=mgr, seed=5,
                 device="cpu")
    tr.run(3, ckpt_interval=1)
    mgr.repository.wait_cascaded()
    assert mgr.repository.gc().deleted_steps == []  # 3 needs 1 and 2
    assert mgr.repository.local_steps() == [1, 2, 3]
    assert mgr.repository.tier_steps(mgr.repository.remote_tiers[0]) \
        == [1, 2, 3]
    assert not mgr.repository.cascade_errors
    tr.manager = None
    mgr.close()

    mgr2 = T.CheckpointManager.from_policy(str(tmp_path / "fresh"), policy,
                                           device="cpu")
    try:
        tr2 = Trainer(cfg, batch=2, seq_len=16, manager=mgr2, seed=6,
                      device="cpu")
        assert tr2.resume() == 3
        assert mgr2.repository.local_steps() == [1, 2, 3]
        for a, b in zip(leaves((tr2.params, tr2.opt_state)),
                        leaves((tr.params, tr.opt_state))):
            assert torch.equal(a, b)
        a, b = tr.run(1)[-1].loss, tr2.run(1)[-1].loss
        assert a == b
    finally:
        mgr2.close()


def test_world_two_step_cascades_to_a_memory_tier(tmp_path):
    states = _states(1)
    mem = S.MemoryBackend()
    policy = T.CheckpointPolicy(
        engine=T.EnginePolicy(host_cache_bytes=16 << 20, flush_threads=2),
        storage=T.StoragePolicy(tiers=(S.Tier("mem", mem),)),
        dist=T.DistPolicy(world=2))
    mgr = T.CheckpointManager.from_policy(str(tmp_path / "w2"), policy,
                                          device="cpu")
    try:
        mgr.save(1, from_numpy_state(states[1], "cpu"), blocking=True)
        mgr.repository.wait_cascaded()
        assert not mgr.repository.cascade_errors
        names = sorted(f.name for f in mgr.repository.manifest(1).files)
    finally:
        mgr.close()
    assert mem.list(data_key(1, "")) == sorted(data_key(1, n) for n in names)
    assert sum(n.endswith(".dsllm") for n in names) == 2
    out, step = _restore("repro_torch", tmp_path / "fresh",
                         (S.Tier("mem", mem),), states[1])
    assert step == 1
    _assert_state(out, states[1])
