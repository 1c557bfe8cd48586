"""The port's deprecated flat-kwarg ``CheckpointManager`` constructor and
``CheckpointPolicy.from_legacy_kwargs``, held against the JAX package's
(``src/repro/core/policy.py``, ``src/repro/core/checkpoint.py``).

Each legacy kwarg maps onto one policy field as in the reference, a
legacy construction warns and saves a step that the reference restores
bit for bit, mixing ``policy=`` with legacy kwargs raises ``ValueError``,
an unknown name raises ``TypeError``, and ``device=`` stays keyword-only.
"""

import dataclasses
import inspect
import warnings

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.core as J  # noqa: E402
import repro.core.policy as jpolicy  # noqa: E402
from repro.storage.repository import RetentionPolicy as JRetention  # noqa: E402

import repro_torch.core as T  # noqa: E402
import repro_torch.core.policy as tpolicy  # noqa: E402
from repro_torch.storage.repository import RetentionPolicy  # noqa: E402


def test_legacy_kwarg_map_equals_reference():
    assert tpolicy.LEGACY_KWARG_MAP == jpolicy.LEGACY_KWARG_MAP


@pytest.mark.parametrize("kwargs", [
    {},
    {"mode": "snapshot", "host_cache_bytes": 1 << 20, "flush_threads": 3,
     "chunk_bytes": 1 << 16, "throttle_mbps": 50.0, "restore_threads": 2},
    {"manifest_checksums": False, "world": 2, "ack_timeout_s": 3.0},
    {"retention": "keep-2", "delta": "delta"},
])
def test_from_legacy_kwargs_matches_reference(kwargs):
    """Every section and field the reference fills from the same kwargs
    (retention and delta given as each package's own object)."""
    def own(pkg_retention, pkg_delta):
        kw = dict(kwargs)
        if kw.get("retention") == "keep-2":
            kw["retention"] = pkg_retention(keep_last_n=2)
        if kw.get("delta") == "delta":
            kw["delta"] = pkg_delta(keyframe_every=3)
        return kw

    got = T.CheckpointPolicy.from_legacy_kwargs(
        **own(RetentionPolicy, T.DeltaPolicy))
    want = J.CheckpointPolicy.from_legacy_kwargs(
        **own(JRetention, J.DeltaPolicy))
    for section in ("engine", "storage", "dist"):
        g, w = getattr(got, section), getattr(want, section)
        for f in dataclasses.fields(w):
            gv, wv = getattr(g, f.name), getattr(w, f.name)
            if f.name == "retention" and wv is not None:
                assert gv.keep_last_n == wv.keep_last_n
            else:
                assert gv == wv, (section, f.name)
    if want.delta is None:
        assert got.delta is None
    else:
        assert got.delta.keyframe_every == want.delta.keyframe_every


def test_legacy_kwargs_warn_save_and_restore_through_reference(tmp_path):
    w = np.random.default_rng(7).normal(size=(64, 48)).astype(np.float32)
    state = {"model": {"w": torch.from_numpy(w.copy())},
             "meta": {"step": 1, "note": "legacy"}}
    with pytest.warns(DeprecationWarning, match="from_policy"):
        mgr = T.CheckpointManager(str(tmp_path), mode="datastates",
                                  host_cache_bytes=8 << 20,
                                  flush_threads=2, chunk_bytes=1 << 16,
                                  device="cpu")
    try:
        assert mgr.policy.engine.flush_threads == 2
        assert mgr.policy.engine.chunk_bytes == 1 << 16
        mgr.save(1, state, blocking=True)
        mgr.wait_for_commit()
        assert not mgr.commit_errors
    finally:
        mgr.close()
    jm = J.CheckpointManager.from_policy(str(tmp_path))
    try:
        out = jm.restore({"model": {"w": jnp.zeros((64, 48), jnp.float32)},
                          "meta": {"step": 0, "note": ""}}, step=1)
    finally:
        jm.close()
    got = np.asarray(out["model"]["w"])
    assert got.dtype == np.float32 and got.shape == w.shape
    np.testing.assert_array_equal(got.view(np.uint32), w.view(np.uint32))
    assert out["meta"] == {"step": 1, "note": "legacy"}


def test_policy_constructor_does_not_warn(tmp_path):
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        T.CheckpointManager(str(tmp_path), policy=T.CheckpointPolicy(),
                            device="cpu").close()
        T.CheckpointManager.from_policy(str(tmp_path), device="cpu").close()


def test_policy_with_legacy_kwargs_or_unknown_name_raises(tmp_path):
    with pytest.raises(ValueError, match="either policy= or legacy"):
        T.CheckpointManager(str(tmp_path), mode="sync",
                            policy=T.CheckpointPolicy(), device="cpu")
    with pytest.raises(TypeError, match="unknown CheckpointManager"):
        T.CheckpointPolicy.from_legacy_kwargs(flush_thread=4)
    with pytest.raises(TypeError):
        T.CheckpointManager(str(tmp_path), flush_thread=4, device="cpu")
    # no card here: the default device still raises, legacy kwargs or not
    with pytest.warns(DeprecationWarning):
        with pytest.raises(RuntimeError, match="is_available"):
            T.CheckpointManager(str(tmp_path / "c"), mode="datastates")


def test_device_is_keyword_only_and_positional_order_matches_reference():
    tparams = inspect.signature(T.CheckpointManager.__init__).parameters
    jparams = inspect.signature(J.CheckpointManager.__init__).parameters

    def positional(params):
        return [n for n, p in params.items()
                if p.kind is p.POSITIONAL_OR_KEYWORD]
    assert positional(tparams) == positional(jparams)
    assert tparams["device"].kind is inspect.Parameter.KEYWORD_ONLY
    assert tparams["device"].default == "cuda"
    assert tparams["policy"].kind is inspect.Parameter.KEYWORD_ONLY
    fp = inspect.signature(T.CheckpointManager.from_policy).parameters
    assert list(fp) == ["directory", "policy", "device"]
