"""The port's whole slice held against the JAX package.

Smoke-size llama3.2-1b training state (bf16 params, fp32 master/m/v, a
0-d int32 step count, Python objects) evolves through three AdamW steps
made by the JAX package from seeded numpy gradients. Under
``DeltaPolicy(keyframe_every=3)`` the saves are keyframe, delta, delta.

* ``repro`` saves and ``repro_torch`` (``device="cpu"``) restores every
  step; ``repro_torch`` saves and ``repro`` restores every step and passes
  ``repro``'s ``verify_step``. Both directions are checked bit for bit
  against the **saved input states**, never against one package's
  restored output.
* The port's own two-phase loop resumes bit-exactly.
* Import discipline, the explicit device, and configurations the port
  refuses (refused, never silently ignored). Remote tiers and retention
  are held against the JAX package in ``tests/test_torch_storage.py``.
  Multi-rank saves are
  held against the JAX package in ``tests/test_torch_dist.py``. The baseline engines are held against the JAX
  package in ``tests/test_torch_baselines.py``.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.core as J
import repro.core.codecs as jcodecs
from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.models.model import init_params as jinit_params
from repro.storage.repository import CheckpointRepository as JRepository

import repro_torch.core as T
from repro_torch.configs import get_config, smoke_variant
from repro_torch.convert import from_numpy_state, to_numpy_state
from repro_torch.core.tree import flatten_with_path, leaves, path_str
from repro_torch.models.model import init_params, param_shapes
from repro_torch.optim import adamw

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _np(tree):
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) if isinstance(x, jax.Array) else x, tree)


def _jax(tree):
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(x) if isinstance(x, np.ndarray) else x, tree)


@pytest.fixture(scope="module")
def states():
    """{step: numpy state} for steps 1..3: smoke-size llama3.2-1b params
    (bf16), fp32 master/m/v and a 0-d int32 count, each step changing
    part of every tensor as a training step would."""
    cfg = smoke_variant(get_config("llama3.2-1b"))
    specs = flatten_with_path(param_shapes(cfg))
    rng = np.random.default_rng(0)

    def draw(spec):
        x = rng.standard_normal(spec.shape).astype(np.float32)
        return x.astype(ml_dtypes.bfloat16) if spec.dtype == "bfloat16" \
            else x
    flat = [draw(spec) for _p, spec in specs[0]]
    opt = {k: [rng.standard_normal(x.shape).astype(np.float32)
               for x in flat] for k in ("master", "m", "v")}
    out = {}
    for step in (1, 2, 3):
        for group in (flat, opt["master"], opt["m"], opt["v"]):
            for i, x in enumerate(group):
                x = x.copy()
                hit = rng.random(x.shape) < 0.5
                x[hit] = (rng.standard_normal(int(hit.sum())) * 1e-3
                          + x[hit].astype(np.float32)).astype(x.dtype)
                group[i] = x
        unflatten = specs[1]
        out[step] = {
            "model": unflatten(list(flat)),
            "optimizer": {"master": unflatten(list(opt["master"])),
                          "m": unflatten(list(opt["m"])),
                          "v": unflatten(list(opt["v"])),
                          "count": np.array(step, np.int32)},
            "meta": {"step": step, "arch": cfg.name, "hp": {"lr": 1e-4}}}
    return out


def test_param_tree_matches_reference():
    """The port's parameter tree is the JAX package's: paths, shapes and
    dtypes of ``init_params`` for the smoke and the 2-layer full-width
    configurations."""
    from repro.core.distributed import _path_str
    for n_layers in (None, 2):
        kw = {} if n_layers is None else {
            "n_layers": 2, "layer_groups": ((("full",), 2),),
            "d_model": 64, "d_ff": 128, "vocab": 96}
        jcfg = jsmoke(jget_config("llama3.2-1b")) if not kw \
            else jget_config("llama3.2-1b", **kw)
        cfg = smoke_variant(get_config("llama3.2-1b")) if not kw \
            else get_config("llama3.2-1b", **kw)
        want = [(_path_str(k), tuple(v.shape), str(v.dtype)) for k, v in
                jax.tree_util.tree_flatten_with_path(
                    jax.eval_shape(lambda: jinit_params(
                        jcfg, jax.random.PRNGKey(0))))[0]]
        got = [(path_str(k), tuple(v.shape), v.dtype) for k, v in
               flatten_with_path(param_shapes(cfg))[0]]
        assert got == want


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return a.view(np.uint16)
    return a


def _assert_tree_equal(got, want):
    g = jax.tree_util.tree_leaves(got)
    w = jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(_bits(a), _bits(b))
            assert np.asarray(a).shape == b.shape
        else:
            assert a == b


def _delta_policy(mod):
    return mod.CheckpointPolicy(
        engine=mod.EnginePolicy(host_cache_bytes=64 << 20),
        delta=mod.DeltaPolicy(keyframe_every=3))


def test_repro_saves_port_restores_every_step(tmp_path, states):
    jm = J.CheckpointManager.from_policy(str(tmp_path), _delta_policy(J))
    for step in (1, 2, 3):
        jm.save(step, _jax(states[step]))
    jm.wait_for_persist()
    jm.wait_for_commit()
    assert not jm.commit_errors
    jm.close()
    tm = T.CheckpointManager.from_policy(str(tmp_path), _delta_policy(T),
                                         device="cpu")
    try:
        assert tm.repository.steps() == [1, 2, 3]
        assert tm.repository.chain_steps(3) == [1, 2, 3]
        template = from_numpy_state(states[1], "cpu")
        for step in (3, 1, 2):
            out = tm.restore(template, step=step)
            assert all(t.device.type == "cpu" for t in leaves(out)
                       if isinstance(t, torch.Tensor))
            _assert_tree_equal(to_numpy_state(out), states[step])
            assert tm.repository.verify_step(step).ok
    finally:
        tm.close()


def test_port_saves_repro_restores_and_verifies(tmp_path, states):
    tm = T.CheckpointManager.from_policy(str(tmp_path), _delta_policy(T),
                                         device="cpu")
    try:
        futs = [tm.save(step, from_numpy_state(states[step], "cpu"))
                for step in (1, 2, 3)]
        tm.wait_for_persist()
        tm.wait_for_commit()
        assert not tm.commit_errors
        kinds = [f.stats.extra["delta"]["keyframe"] for f in futs]
        assert kinds == [True, False, False]
    finally:
        tm.close()
    repo = JRepository(str(tmp_path))
    for step in (1, 2, 3):
        assert repo.verify_step(step).ok
    assert repo.chain_steps(3) == [1, 2, 3]
    jm = J.CheckpointManager.from_policy(str(tmp_path), _delta_policy(J))
    try:
        template = _jax(states[1])
        for step in (3, 1, 2):
            out = jm.restore(template, step=step)
            _assert_tree_equal(_np(out), states[step])
    finally:
        jm.close()


def test_two_phase_loop_resumes_bit_exactly(tmp_path):
    cfg = smoke_variant(get_config("llama3.2-1b"))
    gen = torch.Generator().manual_seed(3)
    params = init_params(cfg, gen, "cpu")
    opt = adamw.init_opt_state(params)
    flat, unflatten = flatten_with_path(params)
    hp = adamw.AdamWConfig()

    def grads_for(step):
        g = torch.Generator().manual_seed(100 + step)
        return unflatten([(torch.randn(t.shape, generator=g) * 1e-2)
                          .to(t.dtype) for _p, t in flat])

    def state(p, o, step):
        return {"model": p, "optimizer": o, "meta": {"step": step}}

    mgr = T.CheckpointManager.from_policy(str(tmp_path), _delta_policy(T),
                                          device="cpu")
    try:
        for step in (1, 2, 3, 4):
            grads = grads_for(step)
            mgr.wait_for_capture()           # the fence before the update
            adamw.apply_updates(params, opt, grads, hp)
            mgr.save(step, state(params, opt, step))
        mgr.wait_for_persist()
        mgr.wait_for_commit()
        assert mgr.repository.chain_steps(4) == [4]   # keyframe every 3
        assert mgr.repository.chain_steps(3) == [1, 2, 3]
        template = state(
            init_params(cfg, torch.Generator().manual_seed(9), "cpu"),
            adamw.init_opt_state(params), 0)
        resumed = mgr.restore(template)
        assert mgr.last_restored_step == 4
        r_params, r_opt = resumed["model"], resumed["optimizer"]
        assert resumed["meta"]["step"] == 4
        for step in (5, 6):
            adamw.apply_updates(params, opt, grads_for(step), hp)
            adamw.apply_updates(r_params, r_opt, grads_for(step), hp)
        for a, b in zip(leaves((params, opt)), leaves((r_params, r_opt))):
            assert torch.equal(a, b)
        # the delta-chain step restores bit-exactly too
        out = mgr.restore(template, step=3)
        assert out["meta"]["step"] == 3
    finally:
        mgr.close()


def test_selective_restore_reads_only_requested_domains(tmp_path, states):
    mgr = T.CheckpointManager.from_policy(str(tmp_path), T.CheckpointPolicy(
        engine=T.EnginePolicy(host_cache_bytes=64 << 20)), device="cpu")
    try:
        mgr.save(1, from_numpy_state(states[1], "cpu"), blocking=True)
        full_template = from_numpy_state(states[2], "cpu")
        mgr.restore(full_template, step=1)
        full = mgr.last_restore_stats.bytes_read
        out = mgr.restore(full_template, step=1, domains=("model",))
        assert mgr.last_restore_stats.bytes_read < full / 3
        _assert_tree_equal(to_numpy_state(out["model"]),
                           states[1]["model"])
        assert out["optimizer"] is full_template["optimizer"]
    finally:
        mgr.close()


def test_corrupt_chain_member_refuses_replay(tmp_path, states):
    mgr = T.CheckpointManager.from_policy(str(tmp_path), _delta_policy(T),
                                          device="cpu")
    try:
        for step in (1, 2):
            mgr.save(step, from_numpy_state(states[step], "cpu"))
        mgr.wait_for_persist()
        mgr.wait_for_commit()
        path = os.path.join(mgr.repository.step_dir(1), "rank00000.dsllm")
        with open(path, "r+b") as f:
            f.seek(4096 * 2 + 5)
            b = f.read(1)
            f.seek(4096 * 2 + 5)
            f.write(bytes([b[0] ^ 0x01]))
        res = mgr.repository.verify_step(1)
        assert not res.ok and res.chunk_mismatch
        with pytest.raises(T.RestoreError, match="failed verification"):
            mgr.restore(from_numpy_state(states[1], "cpu"), step=2)
    finally:
        mgr.close()


def test_dtype_converting_restore_is_refused(tmp_path):
    """A delta chain refuses a template of another dtype, as the
    reference does; a raw step (the keyframe) restores into one with its
    values cast (``tests/test_torch_baselines.py`` holds the bits against
    ``repro``)."""
    mgr = T.CheckpointManager.from_policy(str(tmp_path), T.CheckpointPolicy(
        engine=T.EnginePolicy(host_cache_bytes=1 << 20),
        delta=T.DeltaPolicy(keyframe_every=3)), device="cpu")
    try:
        mgr.save(1, {"w": torch.ones(4, dtype=torch.bfloat16)},
                 blocking=True)
        mgr.save(2, {"w": torch.full((4,), 2.0, dtype=torch.bfloat16)},
                 blocking=True)
        with pytest.raises(T.RestoreError, match="dtype"):
            mgr.restore({"w": torch.ones(4, dtype=torch.float32)}, step=2)
        out = mgr.restore({"w": torch.zeros(4, dtype=torch.float32)},
                          step=1)
        assert torch.equal(out["w"], torch.ones(4, dtype=torch.float32))
        out = mgr.restore({"w": torch.zeros(4, dtype=torch.bfloat16)},
                          step=2)
        assert torch.equal(out["w"],
                           torch.full((4,), 2.0, dtype=torch.bfloat16))
    finally:
        mgr.close()


def test_reservation_outlives_every_chunk_write(tmp_path, monkeypatch):
    """A tensor's pinned-cache reservation is released only after every
    one of its chunks is written: the flush lanes finish chunks out of
    order, and a raw chunk is a view of the reservation the next save
    reuses. The first chunk's write is held until the other seven are
    written; the release must still come after it."""
    import threading

    from repro_torch.core import layout, state_provider

    n_chunks = 8
    done, released = [], []
    lock = threading.Lock()
    others = threading.Condition(lock)
    first = [True]
    orig_write = layout.FileWriter.write_at
    orig_release = state_provider.TensorStateProvider.release

    def write_at(self, offset, data):
        with lock:
            hold, first[0] = first[0], False
            if hold:
                assert others.wait_for(lambda: len(done) == n_chunks - 1,
                                       timeout=30)
        orig_write(self, offset, data)
        with lock:
            done.append(offset)
            others.notify_all()

    def release(self):
        with lock:
            released.append(len(done))
        orig_release(self)

    monkeypatch.setattr(layout.FileWriter, "write_at", write_at)
    monkeypatch.setattr(state_provider.TensorStateProvider, "release",
                        release)
    mgr = T.CheckpointManager.from_policy(str(tmp_path), T.CheckpointPolicy(
        engine=T.EnginePolicy(host_cache_bytes=1 << 20, flush_threads=2,
                              chunk_bytes=1024)), device="cpu")
    try:
        w = torch.arange(256 * n_chunks, dtype=torch.float32)
        mgr.save(1, {"w": w}, blocking=True)
        assert not mgr.commit_errors
        assert len(done) == n_chunks and released[0] == n_chunks
        out = mgr.restore({"w": torch.zeros_like(w)}, step=1)
        assert torch.equal(out["w"], w)
    finally:
        mgr.close()


def test_zero_size_host_leaf_fails_like_repro(tmp_path):
    """A zero-size host array fails the save in both packages alike (a
    known fault of the reference, kept rather than fixed in one place)."""
    causes = []
    for mod, kw in ((J, {}), (T, {"device": "cpu"})):
        mgr = mod.CheckpointManager.from_policy(
            str(tmp_path / mod.__name__), mod.CheckpointPolicy(
                engine=mod.EnginePolicy(host_cache_bytes=1 << 20)), **kw)
        try:
            fut = mgr.save(1, {"w": np.zeros((0, 4), np.float32)})
            with pytest.raises(mod.CheckpointError) as info:
                fut.wait_persisted(timeout=60)
            causes.append(type(info.value.__cause__))
        finally:
            mgr.close()
    assert causes[0] is causes[1] is TypeError


def test_cuda_device_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="is_available"):
        T.CheckpointManager.from_policy(str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.CheckpointManager.from_policy(str(tmp_path), device="cuda")


@pytest.mark.parametrize("policy,match", [
    # multi-rank saves are ported (tests/test_torch_dist.py); what stays
    # refused there is refused as the JAX package refuses it: a baseline
    # engine cannot be a coordinator's rank lane
    pytest.param(T.CheckpointPolicy(engine=T.EnginePolicy(mode="sync"),
                                    dist=T.DistPolicy(world=2)),
                 "DataMovementEngine mode", id="policy0-multi-rank"),
    # remote tiers are ported (tests/test_torch_storage.py); a tier that
    # is not a Tier object is refused before any save
    (T.CheckpointPolicy(storage=T.StoragePolicy(tiers=("peer",))), "tiers"),
])
def test_unported_configurations_are_refused(tmp_path, policy, match):
    exc = ValueError if match == "DataMovementEngine mode" else TypeError
    with pytest.raises(exc, match=match):
        T.CheckpointManager.from_policy(str(tmp_path), policy, device="cpu")


def test_quantized_route_is_refused(tmp_path):
    """The quantized route takes float32 leaves only: a bf16 leaf routed
    to it fails the save in both packages alike, never quantizing it."""
    for mod, kw, leaf in (
            (J, {}, jnp.zeros(8, jnp.bfloat16)),
            (T, {"device": "cpu"}, torch.zeros(8, dtype=torch.bfloat16))):
        reg = mod.StateProviderRegistry(
            [mod.ProviderRule(provider="quantized")])
        mgr = mod.CheckpointManager.from_policy(
            str(tmp_path / mod.__name__), mod.CheckpointPolicy(
                providers=reg), **kw)
        try:
            with pytest.raises(ValueError, match="requires float32"):
                mgr.save(1, {"m": leaf}, blocking=True)
            assert mgr.latest_step() is None
        finally:
            mgr.close()


def _mixed_policy(mod):
    """Params delta-routed (keyframe every 3), fp32 optimizer state
    quantized, 64 KiB chunks so every leaf crosses several encodes."""
    return mod.CheckpointPolicy(
        engine=mod.EnginePolicy(host_cache_bytes=64 << 20,
                                chunk_bytes=1 << 16),
        delta=mod.DeltaPolicy(keyframe_every=3),
        providers=(mod.StateProviderRegistry()
                   .add_rule(provider="quantized", domain="optimizer",
                             dtype="float32")
                   .add_rule(provider="auto")))


def _int8_round_trip(x: np.ndarray) -> np.ndarray:
    """The reference codec's encode then decode of one fp32 leaf."""
    raw = np.ascontiguousarray(x).reshape(-1).view(np.uint8)
    payload, dig = jcodecs.encode_int8_block(raw, with_digest=True)
    out = jcodecs.decode_int8_block(payload, 0, raw.size, expect_digest=dig)
    return out.view(np.float32).reshape(x.shape)


def _quantized(state):
    """``state`` as a mixed-policy restore returns it: params, the count
    and the objects exact, master/m/v through the int8 round trip."""
    opt = dict(state["optimizer"])
    for key in ("master", "m", "v"):
        opt[key] = jax.tree_util.tree_map(_int8_round_trip, opt[key])
    return {**state, "optimizer": opt}


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_quantized_steps_cross_packages(tmp_path, states, writer):
    """K, delta, delta under the mixed policy, written by either package
    and read by both: every leaf equal bit for bit across the readers,
    params exact against the saved input, quantized leaves equal to the
    reference codec's round trip of it, and ``repro``'s ``verify_step``
    passes on every step."""
    if writer == "repro":
        jm = J.CheckpointManager.from_policy(str(tmp_path),
                                             _mixed_policy(J))
        for step in (1, 2, 3):
            jm.save(step, _jax(states[step]))
        jm.wait_for_persist()
        jm.wait_for_commit()
        assert not jm.commit_errors
        jm.close()
    else:
        tm = T.CheckpointManager.from_policy(str(tmp_path), _mixed_policy(T),
                                             device="cpu")
        try:
            futs = [tm.save(step, from_numpy_state(states[step], "cpu"))
                    for step in (1, 2, 3)]
            tm.wait_for_persist()
            tm.wait_for_commit()
            assert not tm.commit_errors
            doms = futs[1].stats.extra["domains"]
            assert [f.stats.extra["delta"]["keyframe"] for f in futs] == \
                [True, False, False]
        finally:
            tm.close()
        assert "int8q+zstd" in str(doms["optimizer"])
    repo = JRepository(str(tmp_path))
    for step in (1, 2, 3):
        assert repo.verify_step(step).ok
    jm = J.CheckpointManager.from_policy(str(tmp_path), _mixed_policy(J))
    tm = T.CheckpointManager.from_policy(str(tmp_path), _mixed_policy(T),
                                         device="cpu")
    try:
        for step in (3, 1, 2):
            want = _quantized(states[step])
            got_t = to_numpy_state(tm.restore(
                from_numpy_state(states[1], "cpu"), step=step))
            got_j = _np(jm.restore(_jax(states[1]), step=step))
            _assert_tree_equal(got_t, got_j)
            _assert_tree_equal(got_t, want)
            assert tm.repository.verify_step(step).ok
    finally:
        jm.close()
        tm.close()


def _int8_leaf(n_values: int, seed: int) -> np.ndarray:
    """Seeded fp32 values (normal, times 10) with, where there are 3 rows,
    a zero second row and a third holding rounding ties."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n_values) * 10).astype(np.float32)
    if n_values >= 768:
        x[256:768] = 0
        x[512:522] = [127, -127, 0.5, -0.5, 2.5, -2.5, 3.5, -3.5, 126.5,
                      -126.5]
    return x


@pytest.mark.parametrize("cap", [1, 1 << 30])
def test_quantized_provider_encodes_in_pieces(cap):
    """``QuantizedStateProvider`` on the CPU, 2 KiB chunks, a tensor of 35
    chunks with a ragged tail, so it crosses three pieces: every chunk's
    payload, digest and raw range are ``repro``'s ``encode_int8_block``
    of that chunk alone, under an encode budget that admits a piece ahead
    (``1 << 30``) or only one piece at a time (``1``); every reservation
    comes back."""
    from repro_torch.core.state_provider import (EncodeBudget,
                                                 QuantizedStateProvider)
    x = _int8_leaf(34 * 512 + 250, seed=cap % 7)
    raw = x.view(np.uint8)
    p = QuantizedStateProvider("m", dtype="float32", shape=x.shape,
                               nbytes=x.nbytes, device="cpu", host_array=x,
                               chunk_bytes=2048)
    p.checksum_chunks = True
    p.encode_budget = budget = EncodeBudget(cap)
    got = []
    for c in p.chunks():
        got.append(c)
        c.on_flushed()   # a flush lane writes it at once
    assert [c.raw_range for c in got] == \
        [(lo, min(lo + 2048, raw.size)) for lo in range(0, raw.size, 2048)]
    assert [c.last for c in got] == [False] * 34 + [True]
    for c in got:
        lo, hi = c.raw_range
        jpay, jdig = jcodecs.encode_int8_block(raw[lo:hi], with_digest=True)
        assert bytes(c.data) == jpay and c.digest == jdig
        assert c.codec == "int8q+zstd" and c.offset is None
    assert budget._used == 0


def test_quantized_provider_returns_unflushed_reservations():
    """A stream closed in the middle of a piece credits back every chunk
    it never handed on; the chunks handed on keep theirs."""
    from repro_torch.core.state_provider import (EncodeBudget,
                                                 QuantizedStateProvider)
    x = _int8_leaf(40 * 256, seed=1)
    p = QuantizedStateProvider("m", dtype="float32", shape=x.shape,
                               nbytes=x.nbytes, device="cpu", host_array=x,
                               chunk_bytes=1024)
    p.encode_budget = budget = EncodeBudget(1 << 30)
    stream = p.chunks()
    first = [next(stream) for _ in range(3)]
    stream.close()
    assert budget._used == sum(len(c.data) for c in first)
    for c in first:
        c.on_flushed()
    assert budget._used == 0


def test_port_reads_repro_quantized_step_in_pieces(tmp_path):
    """A quantized step written by ``repro`` with 1 KiB chunks (a leaf of
    41 chunks, three pieces, the last chunk ragged): ``read_encoded_tensor``
    on the CPU decodes every quantized tensor bit for bit as ``repro``'s
    reader does."""
    policy = J.CheckpointPolicy(
        engine=J.EnginePolicy(host_cache_bytes=16 << 20, chunk_bytes=1024),
        providers=(J.StateProviderRegistry()
                   .add_rule(provider="quantized", domain="optimizer",
                             dtype="float32")
                   .add_rule(provider="auto")))
    state = {"model": {"w": jnp.asarray(_int8_leaf(300, seed=2))},
             "optimizer": {"m": jnp.asarray(_int8_leaf(40 * 256 + 77, 3)),
                           "v": jnp.asarray(_int8_leaf(5 * 256, 4))}}
    jm = J.CheckpointManager.from_policy(str(tmp_path), policy)
    jm.save(1, state)
    jm.wait_for_persist()
    jm.wait_for_commit()
    jm.close()
    from repro.core.layout import FileReader as JReader
    from repro_torch.core.layout import FileReader as TReader
    step = JRepository(str(tmp_path)).step_dir(1)
    paths = [os.path.join(step, f) for f in sorted(os.listdir(step))
             if f.endswith(".dsllm")]
    seen = 0
    for path in paths:
        tr, jr = TReader(path), JReader(path)
        for name, e in tr.tensors.items():
            if e.codec == "raw":
                continue
            seen += 1
            np.testing.assert_array_equal(tr.read_encoded_tensor(name, "cpu"),
                                          jr.read_encoded_tensor(name))
            if e.nbytes > 40 * 1024:
                assert len(e.enc_chunks) == 41
    assert seen == 2


def test_flipped_byte_in_a_piece_names_its_chunk(tmp_path):
    """20 chunks of one int8q tensor, the third holding a validly
    compressed payload with one byte flipped, stored against its original
    digest: ``read_encoded_tensor`` raises ``CodecError`` naming that
    chunk, and ``locate_corrupt_chunks`` names it alone."""
    from repro_torch.core import codecs as tcodecs
    from repro_torch.core.layout import FileLayout, FileReader, FileWriter
    from repro_torch.core.reduction import _compress
    x = _int8_leaf(20 * 512, seed=5)
    raw = x.view(np.uint8)
    path = str(tmp_path / "q.dsllm")
    w = FileWriter(path, FileLayout.plan([]))
    w.declare_encoded_tensor("t", dtype="float32", shape=x.shape,
                             nbytes=raw.size, codec=tcodecs.INT8_CODEC)
    for k, lo in enumerate(range(0, raw.size, 2048)):
        payload, dig = jcodecs.encode_int8_block(raw[lo:lo + 2048],
                                                 with_digest=True)
        if k == 2:
            bad = bytearray(payload)
            bad[8 + 4 * 2 + 300] ^= 0x10
            payload = bytes(bad)
        w.append_encoded_chunk("t", _compress(payload), lo, lo + 2048,
                               digest=dig)
    w.finalize()
    r = FileReader(path)
    with pytest.raises(tcodecs.CodecError,
                       match=r"digest mismatch.*chunk \[4096:6144\)"):
        r.read_encoded_tensor("t", "cpu")
    assert r.locate_corrupt_chunks("cpu") == ["t int8q+zstd chunk [4096:6144)"]


def test_quantized_optimizer_restores_by_domain(tmp_path, states):
    """``domains=("optimizer",)`` on a delta step of the mixed policy:
    the quantized leaves decode standalone, the delta-routed count
    replays its chain, and the model domain is the template's own."""
    tm = T.CheckpointManager.from_policy(str(tmp_path), _mixed_policy(T),
                                         device="cpu")
    try:
        for step in (1, 2):
            tm.save(step, from_numpy_state(states[step], "cpu"))
        tm.wait_for_persist()
        tm.wait_for_commit()
        template = from_numpy_state(states[1], "cpu")
        tm.restore(template, step=2)
        full = tm.last_restore_stats.bytes_read
        out = tm.restore(template, step=2, domains=("optimizer",))
        assert tm.last_restore_stats.bytes_read < full
        assert out["model"] is template["model"]
        _assert_tree_equal(to_numpy_state(out["optimizer"]),
                           _quantized(states[2])["optimizer"])
    finally:
        tm.close()


def test_plan_shards_names_match_reference(states):
    state = states[1]
    t_recs, t_objs = T.plan_shards(from_numpy_state(state, "cpu"), "state")
    j_recs, j_objs = J.plan_shards(_jax(state), "state")
    key = (lambda r: (r.tensor_name, r.dtype, r.shape, r.nbytes, r.index,
                      r.domain, r.device_resident))
    assert sorted(map(key, t_recs)) == sorted(map(key, j_recs))
    assert t_objs == j_objs
    assert "state/model/groups/0/0/attn/wq@[0:1,0:256,0:256]" in \
        {r.tensor_name for r in t_recs}
    count = [r for r in t_recs if r.leaf_path == "state/optimizer/count"]
    assert count[0].shape == () and count[0].nbytes == 4


#: the port's programs outside its package: every file of these
#: directories, and the smoke run
PORT_PROGRAM_DIRS = ("examples/torch", "scripts/torch")
PORT_PROGRAMS = ("chip_smoke.py",)


def _port_files():
    root = os.path.join(SRC, "..")
    files = [os.path.join(d, f) for top in ("src/repro_torch",)
             for d, _dirs, fs in os.walk(os.path.join(root, top))
             for f in fs if f.endswith(".py")]
    for top in PORT_PROGRAM_DIRS:
        files += [os.path.join(root, top, f)
                  for f in sorted(os.listdir(os.path.join(root, top)))
                  if f.endswith(".py")]
    return files + [os.path.join(root, f) for f in PORT_PROGRAMS]


def _imported_tops(path):
    import ast
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_neither_jax_nor_repro():
    """The package, its examples and scripts and the smoke run import
    neither JAX nor the JAX package: no import statement names them
    (function-local ones included), and each module and program imports
    with them blocked."""
    files = _port_files()
    assert sum("examples/torch" in f for f in files) == 6
    assert sum("scripts/torch" in f for f in files) == 5
    for path in files:
        bad = {m for m in _imported_tops(path)
               if m in ("jax", "jaxlib", "repro")}
        assert not bad, f"{path} imports {sorted(bad)}"
    programs = [f for f in files if "src/repro_torch" not in f]
    code = (
        "import sys, pkgutil, importlib, importlib.util\n"
        "for m in ('jax', 'repro', 'msgpack', 'ml_dtypes', 'triton'):\n"
        "    sys.modules[m] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "for i, path in enumerate(sys.argv[1:]):\n"
        "    spec = importlib.util.spec_from_file_location(f'p{i}', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code] + programs, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 30


def test_port_restores_a_sharded_repro_step(tmp_path):
    """A step the JAX package saved from a 2-way sharded array (two stored
    shards, each a strided part of the leaf) restores whole."""
    code = (
        "import os, sys\n"
        "os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=2'\n"
        "import jax, numpy as np\n"
        "from jax.sharding import NamedSharding, PartitionSpec as P\n"
        "import repro.core as J\n"
        "mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]), ('x',))\n"
        "w = np.arange(24, dtype=np.float32).reshape(4, 6)\n"
        "a = jax.device_put(w, NamedSharding(mesh, P(None, 'x')))\n"
        "m = J.CheckpointManager.from_policy(sys.argv[1])\n"
        "m.save(1, {'w': a}, blocking=True)\n"
        "m.close()\n")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    mgr = T.CheckpointManager.from_policy(str(tmp_path), device="cpu")
    try:
        got = mgr.restore({"w": torch.zeros(4, 6)}, step=1)
        assert torch.equal(got["w"], torch.arange(24.0).reshape(4, 6))
    finally:
        mgr.close()
