"""The port's fleet warm-start fabric held against the JAX package's.

The cases of ``tests/test_fleet.py`` against ``repro_torch.fleet``:
single flight, LRU eviction, oversized pass-through, a failed leader,
capacity churn, disjoint peer slices, a dying peer, a corrupt slice, a
failed remote read, a short read, end-to-end amplification at most 1.25x
with the ledger and ``stats --fleet``, one admission per shared root, a
delta pull that moves only chain bytes, and the fallback when no tier
holds the step. Each case orders its threads with ``Event``, ``Barrier``
or a ``Condition``, never with a sleep: a waiter is counted when it
blocks on the flight, and a remote read waits until every replica has
claimed a slice of the object.

The peer digest equals ``repro``'s on the same bytes, and
``load_params_for_serving(repository=..., fleet=FleetFabric(device="cpu"))``
gives ``repro``'s params for the same saved step. ``gpu``-marked tests
hold the admission and slice digests on the card against their plain
versions and run a smoke-size warm-start on ``cuda``; they skip inside
the test on a host without one.
"""

import os
import shutil
import threading
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.fleet as JF  # noqa: E402
import repro.storage as JS  # noqa: E402
from repro.fleet.peer import _digest as jdigest  # noqa: E402
from repro.serving.engine import load_params_for_serving as jload  # noqa: E402
from repro.storage import cli as jcli  # noqa: E402

import repro_torch.core as T  # noqa: E402
import repro_torch.fleet.cache as cache_mod  # noqa: E402
import repro_torch.storage as S  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.convert import from_numpy_state, to_numpy_state  # noqa: E402
from repro_torch.core.tree import flatten_with_path, leaves  # noqa: E402
from repro_torch.fleet import (FLEET_STATS_KEY, ExchangeStats,  # noqa: E402
                               FleetCache, FleetFabric, PeerExchange)
from repro_torch.fleet.peer import _digest  # noqa: E402
from repro_torch.models.model import param_shapes  # noqa: E402
from repro_torch.serving.engine import load_params_for_serving  # noqa: E402
from repro_torch.storage import cli as tcli  # noqa: E402
from repro_torch.storage.manifest import file_checksum  # noqa: E402
from repro_torch.storage.repository import catalog_key  # noqa: E402

TIMEOUT = 30.0


def _fan(n, fn):
    """Run ``fn(i)`` on n threads; re-raise the first failure."""
    errors = []

    def wrap(i):
        try:
            fn(i)
        except BaseException as exc:  # noqa: BLE001 — surfaced below
            errors.append(exc)

    threads = [threading.Thread(target=wrap, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    if errors:
        raise errors[0]


class _Waiters:
    """Counts threads blocked on a cache flight's event."""

    def __init__(self):
        self.n = 0
        self.cond = threading.Condition()

    def arrived(self):
        with self.cond:
            self.n += 1
            self.cond.notify_all()

    def wait_for(self, k):
        with self.cond:
            assert self.cond.wait_for(lambda: self.n >= k, timeout=TIMEOUT)


@pytest.fixture
def waiters(monkeypatch):
    """Every flight the cache opens counts the threads that wait on it."""
    w = _Waiters()

    class CountingEvent(threading.Event):
        def wait(self, timeout=None):
            w.arrived()
            return super().wait(timeout)

    class Flight(cache_mod._Flight):
        __slots__ = ()

        def __init__(self):
            super().__init__()
            self.event = CountingEvent()

    monkeypatch.setattr(cache_mod, "_Flight", Flight)
    return w


# ------------------------------------------------------------- FleetCache
def test_cache_single_flight_dedup(waiters):
    """K concurrent restorers of one key cause exactly one remote read."""
    cache = FleetCache(capacity_bytes=1 << 20)
    calls = []

    def fetch():
        calls.append(1)
        waiters.wait_for(7)  # hold the flight until every other caller waits
        return b"x" * 1000

    out = [None] * 8
    _fan(8, lambda i: out.__setitem__(i, cache.get_through("k", fetch)))
    assert sum(calls) == 1
    assert all(o == b"x" * 1000 for o in out)
    assert cache.stats["misses"] == 1 and cache.stats["waits"] == 7
    # stragglers after the flight closes hit the cache, no new fetch
    assert cache.get_through("k", fetch) == b"x" * 1000
    assert sum(calls) == 1 and cache.stats["hits"] >= 1


def test_cache_miss_fallthrough_and_lru_eviction():
    cache = FleetCache(capacity_bytes=1000)
    assert cache.peek("a") is None  # miss: no flight, no fabrication
    cache.get_through("a", lambda: b"a" * 400)
    cache.get_through("b", lambda: b"b" * 400)
    assert cache.peek("a") == b"a" * 400  # freshens a in LRU order
    cache.get_through("c", lambda: b"c" * 400)  # evicts b (LRU)
    assert cache.stats["evictions"] == 1
    assert cache.peek("b") is None
    assert cache.peek("a") == b"a" * 400
    assert cache.peek("c") == b"c" * 400
    assert cache.used_bytes() <= 1000
    cache.invalidate("a")
    assert cache.peek("a") is None
    cache.offer("d", b"d" * 300)
    assert cache.peek("d") == b"d" * 300
    assert cache.snapshot() == cache.stats


def test_cache_oversized_object_passes_through_uncached(waiters):
    """Waiters share the leader's bytes though nothing was cached. The
    leader holds its flight until the three others wait on it, so no
    caller can arrive after the flight closed (the JAX package's test
    races on that: a 20 ms sleep)."""
    cache = FleetCache(capacity_bytes=100)
    calls = []

    def fetch():
        calls.append(1)
        waiters.wait_for(3)
        return b"z" * 5000

    out = [None] * 4
    _fan(4, lambda i: out.__setitem__(i, cache.get_through("big", fetch)))
    assert sum(calls) == 1
    assert all(o == b"z" * 5000 for o in out)
    assert cache.used_bytes() == 0
    assert cache.stats["uncached"] >= 1


def test_cache_failed_leader_wakes_waiters_who_retry(waiters):
    """A leader whose fetch raises must not wedge the flight: the waiter
    retries, becomes leader, and succeeds."""
    cache = FleetCache(capacity_bytes=1 << 20)
    first_in = threading.Event()
    boom = [True]

    def failing():
        if boom[0]:
            boom[0] = False
            first_in.set()
            waiters.wait_for(1)  # the other caller waits on this flight
            raise S.BackendError("remote flaked")
        return b"ok"

    results, errors = [], []

    def caller(i):
        if i == 1:
            assert first_in.wait(TIMEOUT)  # thread 0 owns the flight
        try:
            results.append(cache.get_through("k", failing))
        except S.BackendError as exc:
            errors.append(exc)

    _fan(2, caller)
    assert len(errors) == 1        # the leader's caller sees the failure
    assert results == [b"ok"]      # the waiter retried and succeeded
    assert cache.get_through("k", failing) == b"ok"  # no stuck flight


def test_cache_capacity_pressure_under_concurrent_readers():
    """Readers racing evictions always see full, correct payloads."""
    payloads = {f"k{i}": bytes([i]) * 700 for i in range(8)}
    cache = FleetCache(capacity_bytes=2000)  # holds <3 entries: churn
    start = threading.Barrier(8, timeout=TIMEOUT)

    def reader(i):
        key = f"k{i % 8}"
        start.wait()
        for _ in range(30):
            assert cache.get_through(key, lambda: payloads[key]) \
                == payloads[key]

    _fan(8, reader)
    assert cache.stats["evictions"] > 0  # the pressure was real
    assert cache.used_bytes() <= 2000


# ----------------------------------------------------------- PeerExchange
class _AllClaim:
    """``read_range`` wrapper: each replica's first read waits until all
    ``n`` replicas are reading, so each has claimed a slice before any
    slice is published."""

    def __init__(self, n, read):
        self.barrier = threading.Barrier(n, timeout=TIMEOUT)
        self.local = threading.local()
        self.read = read

    def __call__(self, off, nb):
        if not getattr(self.local, "in", False):
            self.local.__dict__["in"] = True
            self.barrier.wait()
        return self.read(off, nb)


def test_peer_exchange_disjoint_slices_one_remote_copy():
    """R replicas exchanging one object read each remote byte once."""
    payload = os.urandom(1 << 20)
    px = PeerExchange(slice_bytes=64 << 10, device="cpu")
    served = [0]
    lock = threading.Lock()

    def read(off, nb):
        with lock:
            served[0] += nb
        return payload[off:off + nb]

    read_range = _AllClaim(8, read)
    out = [None] * 8
    stats = [ExchangeStats() for _ in range(8)]
    _fan(8, lambda i: out.__setitem__(
        i, px.fetch("obj", len(payload), read_range, stats[i])))
    assert all(o == payload for o in out)
    assert served[0] == len(payload)  # exactly 1x the object, fleet-wide
    assert sum(s.remote_bytes for s in stats) == len(payload)
    assert sum(s.peer_bytes for s in stats) == 7 * len(payload)
    assert all(s.refetched_slices == 0 and s.n_slices == 16 for s in stats)


def test_peer_dying_mid_exchange_degrades_to_remote_reads():
    """A peer that claims a slice and dies stops publishing; its claim
    expires and a live replica reclaims it — no hang, no missing bytes."""
    payload = os.urandom(256 << 10)
    px = PeerExchange(slice_bytes=64 << 10, claim_timeout_s=0.2,
                      device="cpu")
    sess = px._session("obj", len(payload))
    dead_claim = sess.next_claim()
    assert dead_claim is not None and dead_claim >= 0

    def read_range(off, nb):
        return payload[off:off + nb]

    out = [None] * 2
    stats = [ExchangeStats() for _ in range(2)]
    t0 = time.monotonic()
    _fan(2, lambda i: out.__setitem__(
        i, px.fetch("obj", len(payload), read_range, stats[i])))
    assert time.monotonic() - t0 < 5.0  # bounded by the claim timeout
    assert all(o == payload for o in out)
    assert sum(s.reclaimed_slices for s in stats) >= 1


def test_peer_corrupt_slice_fails_digest_and_is_refetched():
    payload = os.urandom(256 << 10)
    px = PeerExchange(slice_bytes=64 << 10, device="cpu")
    sess = px._session("obj", len(payload))
    bad = sess.next_claim()
    off, nb = sess.slices[bad]
    good = payload[off:off + nb]
    corrupt = bytes([good[0] ^ 0xFF]) + good[1:]
    sess.publish(bad, corrupt, _digest(good, "cpu"))  # digest mismatches

    stats = ExchangeStats()
    out = px.fetch("obj", len(payload),
                   lambda off, nb: payload[off:off + nb], stats)
    assert out == payload  # the corrupt slice never reached the assembly
    assert stats.refetched_slices == 1


def test_peer_failed_remote_read_releases_claim():
    payload = os.urandom(128 << 10)
    px = PeerExchange(slice_bytes=32 << 10, device="cpu")
    fail_once = [True]

    def flaky(off, nb):
        if fail_once[0]:
            fail_once[0] = False
            raise S.BackendError("remote flaked")
        return payload[off:off + nb]

    with pytest.raises(S.BackendError, match="flaked"):
        px.fetch("obj", len(payload), flaky)
    assert px.fetch("obj", len(payload),
                    lambda off, nb: payload[off:off + nb]) == payload


def test_short_remote_read_rejected():
    payload = os.urandom(64 << 10)
    px = PeerExchange(slice_bytes=32 << 10, device="cpu")
    with pytest.raises(S.BackendError, match="returned"):
        px.fetch("obj", len(payload),
                 lambda off, nb: payload[off:off + nb - 1])


@pytest.mark.parametrize("n", [0, 1, 3, 4, 4097, (1 << 20) + 5])
def test_peer_digest_matches_reference(n):
    data = np.random.default_rng(n).integers(0, 256, n,
                                             dtype=np.uint8).tobytes()
    assert _digest(data, "cpu") == jdigest(data)


# ------------------------------------------------------------ end-to-end
def _state(n: int, tag: float):
    return {"model": {"w0": np.arange(n, dtype=np.float32) + np.float32(tag),
                      "w1": np.ones((64, 64), np.float32)
                      * np.float32(tag)},
            "meta": {"step": int(tag)}}


class _Remote(S.ObjectStoreBackend):
    """An object store whose ranged reads wait until ``n`` replicas read
    the same object (each replica's first read of a key)."""

    def __init__(self):
        super().__init__()
        self.n = None
        self._gate_lock = threading.Lock()
        self._gates = {}

    def get_range(self, key, offset, nbytes):
        if self.n:
            with self._gate_lock:
                gate = self._gates.setdefault(
                    key, (threading.Barrier(self.n, timeout=TIMEOUT), set()))
                first = threading.get_ident() not in gate[1]
                gate[1].add(threading.get_ident())
            if first:
                gate[0].wait()
        return super().get_range(key, offset, nbytes)


def _train(root, remote, states, delta=None):
    """Save ``states`` ({step: state}) through the port with ``remote`` as
    its object-store tier; returns each step's bytes."""
    policy = T.CheckpointPolicy(
        engine=T.EnginePolicy(host_cache_bytes=16 << 20, flush_threads=1),
        storage=T.StoragePolicy(tiers=(S.Tier("object", remote),)),
        delta=delta)
    mgr = T.CheckpointManager.from_policy(str(root), policy, device="cpu")
    try:
        for step, state in states.items():
            mgr.save(step, from_numpy_state(state, "cpu"), blocking=True)
        mgr.repository.wait_cascaded()
        assert not mgr.commit_errors and not mgr.repository.cascade_errors
        return {s: mgr.repository.manifest(s).total_bytes for s in states}
    finally:
        mgr.close()


def _template(state):
    return {k: torch.empty(v.shape, dtype=torch.float32)
            for k, v in state["model"].items()}


def _assert_params(params, state):
    for k, v in state["model"].items():
        np.testing.assert_array_equal(params[k].numpy(), v)


def _warm_start(tmp_path, remote, roots, step, fabric, state):
    """One replica a root name in ``roots`` (a name twice: two replicas
    on one host share its repository); all start at once. Returns the
    repositories by root and the admissions by (root, step)."""
    repos = {r: S.CheckpointRepository(
        str(tmp_path / r), [S.Tier("object", remote)], device="cpu",
        auto_cascade=False, auto_gc=False) for r in set(roots)}
    admits = []
    for r, repo in repos.items():
        def admit(step, manifest, staging, *, source="fetch", _r=r,
                  _f=repo.admit_fetched_step):
            admits.append((_r, step))
            return _f(step, manifest, staging, source=source)
        repo.admit_fetched_step = admit
    start = threading.Barrier(len(roots), timeout=TIMEOUT)

    def replica(i):
        start.wait()
        repo = repos[roots[i]]
        params, _ = load_params_for_serving(repo.root, _template(state),
                                            step=step, threads=1,
                                            repository=repo, fleet=fabric)
        _assert_params(params, state)

    _fan(len(roots), replica)
    return repos, admits


def test_fabric_end_to_end_amplification_and_ledger(tmp_path, capsys):
    """Four replicas with private local tiers warm-start through one
    fabric: remote egress stays ~1x one checkpoint, bytes are exact on
    every replica, a warmed replica re-resolves locally, and the per-step
    ledger reaches both packages' ``stats --fleet`` alike."""
    remote = _Remote()
    state = _state(65536, 3.0)
    ckpt_bytes = _train(tmp_path / "train", remote, {3: state})[3]
    fabric = FleetFabric(slice_bytes=16 << 10, device="cpu")
    remote.n = 4
    b0 = remote.stats["bytes_out"]
    repos, admits = _warm_start(tmp_path, remote, ["r0", "r1", "r2", "r3"],
                                3, fabric, state)
    remote_bytes = remote.stats["bytes_out"] - b0
    assert remote_bytes <= ckpt_bytes * 1.25  # ~1x, not 4x
    st = fabric.step_stats()[3]
    assert st["replicas"] == 4 and not st["delta"]
    # the ledger: the data file once from remote, three times from peers,
    # the manifest once through the cache; the backend also served each
    # replica's chain walk its own manifest read
    manifest_bytes = len(remote.get(catalog_key(3)))
    assert st["remote_bytes"] == ckpt_bytes + manifest_bytes
    assert st["peer_bytes"] == 3 * ckpt_bytes
    assert st["cache_hits"] == 3
    assert remote_bytes - st["remote_bytes"] <= 4 * 2 * manifest_bytes
    assert sorted(admits) == [(r, 3) for r in ("r0", "r1", "r2", "r3")]
    # a warmed replica re-resolves locally: zero new remote bytes
    b1 = remote.stats["bytes_out"]
    assert repos["r0"].resolve_for_restore(3) == repos["r0"].step_dir(3)
    assert remote.stats["bytes_out"] == b1
    root = repos["r0"].root
    assert os.path.exists(os.path.join(root, FLEET_STATS_KEY))
    # each replica persisted the fleet-wide ledger as it finished; write
    # it once more now that all four have
    fabric.persist(repos["r0"])
    outs = []
    for main, extra in ((jcli.main, []), (tcli.main, ["--device", "cpu"])):
        capsys.readouterr()
        rcs = [main(["--root", root] + extra + ["stats", "--fleet"] + a)
               for a in ([], ["--step", "3"], ["--step", "99"])]
        outs.append((rcs, capsys.readouterr().out))
    assert outs[0] == outs[1] and outs[1][0] == [0, 0, 1]
    assert "replicas=4" in outs[1][1] and "peer=" in outs[1][1]


def test_fabric_admits_once_per_shared_root(tmp_path):
    """Two hosts, two replicas each sharing its host's repository: every
    replica gets the exact bytes and each root admits the step once."""
    remote = _Remote()
    state = _state(16384, 2.0)
    _train(tmp_path / "train", remote, {2: state})
    fabric = FleetFabric(slice_bytes=8 << 10, device="cpu")
    remote.n = 4
    repos, admits = _warm_start(tmp_path, remote, ["h0", "h0", "h1", "h1"],
                                2, fabric, state)
    assert sorted(admits) == [("h0", 2), ("h1", 2)]
    assert fabric.step_stats()[2]["replicas"] == 4
    for repo in repos.values():
        assert repo.local_steps() == [2] and repo.verify_step(2).ok


def test_fabric_cli_stats_fleet_without_ledger(tmp_path, capsys):
    assert tcli.main(["--root", str(tmp_path), "--device", "cpu",
                      "stats", "--fleet"]) == 0
    assert "no fleet transfer ledger" in capsys.readouterr().out


def test_fabric_delta_pull_moves_only_chain_bytes(tmp_path):
    """A fleet already on step 1 warming to delta step 2 transfers the
    delta chain only — never a fresh keyframe."""
    remote = S.ObjectStoreBackend()
    s1 = _state(8192, 1.0)
    s2 = {"model": {k: v + np.float32(0.5) for k, v in s1["model"].items()},
          "meta": {"step": 2}}
    root = tmp_path / "train"
    mgr = T.CheckpointManager.from_policy(str(root), T.CheckpointPolicy(
        engine=T.EnginePolicy(host_cache_bytes=16 << 20, flush_threads=1),
        storage=T.StoragePolicy(tiers=(S.Tier("object", remote),)),
        delta=T.DeltaPolicy(keyframe_every=4)), device="cpu")
    try:
        mgr.save(1, from_numpy_state(s1, "cpu"), blocking=True)
        mgr.repository.wait_cascaded()
        seed = tmp_path / "fleet-at-1"  # the fleet's local tier at step 1
        shutil.copytree(root, seed)
        mgr.save(2, from_numpy_state(s2, "cpu"), blocking=True)
        mgr.repository.wait_cascaded()
        kf_bytes = mgr.repository.manifest(1).total_bytes
        delta_bytes = mgr.repository.manifest(2).total_bytes
        assert mgr.repository.chain_steps(2) == [1, 2]
    finally:
        mgr.close()
    assert delta_bytes < kf_bytes  # the delta really is smaller
    fabric = FleetFabric(slice_bytes=16 << 10, device="cpu")
    b0 = remote.stats["bytes_out"]
    rdir = tmp_path / "replica"
    shutil.copytree(seed, rdir)
    repo = S.CheckpointRepository(str(rdir), [S.Tier("object", remote)],
                                  device="cpu", auto_cascade=False,
                                  auto_gc=False)
    params, _ = load_params_for_serving(str(rdir), _template(s1), step=2,
                                        threads=1, repository=repo,
                                        fleet=fabric)
    _assert_params(params, s2)
    pulled = remote.stats["bytes_out"] - b0
    assert pulled < kf_bytes            # not a keyframe re-read
    assert pulled <= delta_bytes * 1.25 + 16384  # chain bytes + manifest
    assert fabric.step_stats()[2]["delta"] is True
    assert 1 not in fabric.step_stats()
    repo.close()


def test_fabric_falls_back_when_no_remote_tier_has_step(tmp_path):
    """A fabric with nothing to fetch defers to normal resolution (which
    raises the usual not-on-any-tier error) instead of masking it."""
    repo = S.CheckpointRepository(str(tmp_path), [S.Tier(
        "object", S.ObjectStoreBackend())], device="cpu", auto_cascade=False)
    fabric = FleetFabric(device="cpu")
    repo.attach_fleet(fabric)
    assert fabric.fetch_step(repo, 42) is None
    with pytest.raises(FileNotFoundError):
        repo.resolve_for_restore(42)
    repo.close()


# --------------------------------------------------------------- serving
def _smoke_params():
    cfg = smoke_variant(get_config("llama3.2-1b"))
    specs, unflatten = flatten_with_path(param_shapes(cfg))
    rng = np.random.default_rng(11)
    return unflatten([rng.standard_normal(spec.shape).astype(
        ml_dtypes.bfloat16 if spec.dtype == "bfloat16" else np.float32)
        for _p, spec in specs])


def test_serving_through_a_fabric_matches_reference(tmp_path):
    """The port and ``repro`` each warm a fresh root from one tier the
    port wrote (K then delta) through their own fabric: the same
    smoke-size params, bit for bit."""
    p1 = _smoke_params()
    p2 = jax.tree_util.tree_map(
        lambda x: (x.astype(np.float32) + np.float32(1 / 64)).astype(
            x.dtype), p1)
    tier_dir = str(tmp_path / "tier")
    policy = T.CheckpointPolicy(
        engine=T.EnginePolicy(host_cache_bytes=32 << 20, flush_threads=1),
        storage=T.StoragePolicy(tiers=(S.Tier("t", S.LocalBackend(
            tier_dir)),)), delta=T.DeltaPolicy(keyframe_every=3))
    mgr = T.CheckpointManager.from_policy(str(tmp_path / "train"), policy,
                                          device="cpu")
    try:
        for step, p in ((1, p1), (2, p2)):
            mgr.save(step, {"model": from_numpy_state(p, "cpu"),
                            "meta": {"step": step}}, blocking=True)
        mgr.repository.wait_cascaded()
    finally:
        mgr.close()
    repo = S.CheckpointRepository(
        str(tmp_path / "port"), [S.Tier("t", S.LocalBackend(tier_dir))],
        device="cpu", auto_cascade=False)
    got, _ = load_params_for_serving(
        repo.root, from_numpy_state(p1, "cpu"), step=2, repository=repo,
        fleet=FleetFabric(slice_bytes=64 << 10, device="cpu"))
    repo.close()
    jrepo = JS.CheckpointRepository(
        str(tmp_path / "jax"), [JS.Tier("t", JS.LocalBackend(tier_dir))],
        auto_cascade=False)
    want, _ = jload(jrepo.root, jax.tree_util.tree_map(jnp.asarray, p1),
                    step=2, repository=jrepo,
                    fleet=JF.FleetFabric(slice_bytes=64 << 10))
    jrepo.close()
    g = leaves(to_numpy_state(got))
    w = jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        b = np.asarray(b)
        np.testing.assert_array_equal(
            a, b.view(np.uint16) if b.dtype == ml_dtypes.bfloat16 else b)
    for a, b in zip(g, jax.tree_util.tree_leaves(p2)):
        np.testing.assert_array_equal(
            a, b.view(np.uint16) if b.dtype == ml_dtypes.bfloat16 else b)


# ------------------------------------------------------------ on the card
def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_cuda_admission_and_slice_digests_match_plain(tmp_path):
    """``file_checksum`` (admission, CLI ``verify``) and the peer-slice
    digest on the card equal their plain versions, launching the
    digest kernel."""
    _cuda_or_skip()
    from repro_torch.kernels import checksum
    rng = np.random.default_rng(2)
    for n in (1, 4097, 4 << 20, (4 << 20) + 5, (70 << 20) + 3):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        before = checksum.KERNEL.launches
        assert _digest(data, "cuda") == _digest(data, "cpu")
        assert checksum.KERNEL.launches > before
        path = tmp_path / f"f{n}"
        path.write_bytes(data)
        assert file_checksum(str(path), "cuda") \
            == file_checksum(str(path), "cpu")


@pytest.mark.gpu
def test_cuda_fleet_warm_start(tmp_path):
    """Two hosts of two replicas warm-start through one fabric on the
    card: every replica's params on the card, bit for bit."""
    _cuda_or_skip()
    remote = _Remote()
    state = _state(1 << 20, 4.0)
    _train(tmp_path / "train", remote, {4: state})
    fabric = FleetFabric(slice_bytes=256 << 10, device="cuda")
    remote.n = 4
    roots = ["h0", "h0", "h1", "h1"]
    repos = {r: S.CheckpointRepository(
        str(tmp_path / r), [S.Tier("object", remote)], device="cuda",
        auto_cascade=False, auto_gc=False) for r in set(roots)}
    start = threading.Barrier(4, timeout=TIMEOUT)

    def replica(i):
        start.wait()
        tpl = {k: torch.empty(v.shape, dtype=torch.float32, device="cuda")
               for k, v in state["model"].items()}
        params, _ = load_params_for_serving(
            repos[roots[i]].root, tpl, step=4, repository=repos[roots[i]],
            fleet=fabric)
        for k, v in state["model"].items():
            assert params[k].device.type == "cuda"
            np.testing.assert_array_equal(params[k].cpu().numpy(), v)

    _fan(4, replica)
    assert fabric.step_stats()[4]["replicas"] == 4
