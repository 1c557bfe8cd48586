"""Training the attention family past 2,048 tokens, held against the JAX
package's trainer, and its checkpoints across the two packages.

``Trainer`` on ``smoke_variant(musicgen-medium)`` (codebooks, memory,
``xattn`` blocks, layernorm, biases, ``gelu_mlp``) in fp32 at 2,100
tokens, batch 1, 2 steps: attention takes the blocked path under grad
(``layers._Flash``). Started from the JAX trainer's initial params, step
1's loss is within ``rtol=1e-5`` of the JAX trainer's and step 2's within
``rtol=1e-4`` (after one AdamW step, whose normalised update turns
gradient differences of ``1e-7`` into weight differences of up to ``2 lr``
where a gradient is near 0). A step saved by the port restores bit for
bit through ``repro``, and one saved by ``repro`` resumes bit for bit in
the port, the data cursor included.
"""

import dataclasses
import math

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as J  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_variant as jsmoke  # noqa: E402
from repro.training.loop import Trainer as JTrainer  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.convert import from_numpy_state, to_numpy_state  # noqa
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.training.loop import Trainer  # noqa: E402

S = 2100


def _musicgen():
    jcfg = dataclasses.replace(jsmoke(jget_config("musicgen-medium")),
                               dtype="float32")
    cfg = dataclasses.replace(smoke_variant(get_config("musicgen-medium")),
                              dtype="float32")
    return jcfg, cfg


def _port_trainer(cfg, jtrainer, manager=None) -> Trainer:
    """A port trainer starting from the JAX trainer's params."""
    tr = Trainer(cfg, batch=1, seq_len=S, manager=manager, device="cpu")
    params = from_numpy_state(
        jax.tree_util.tree_map(np.asarray, jtrainer.params), "cpu")
    tr.params = jax.tree_util.tree_map(
        lambda t: t.requires_grad_(True), params)
    tr.opt_state = adamw.init_opt_state(tr.params)
    return tr


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 \
        and a.dtype != np.int16 else a


def _assert_state_equal(got, want) -> None:
    g, w = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        if isinstance(b, (np.ndarray, jax.Array)):
            np.testing.assert_array_equal(_bits(a), _bits(b))
        else:
            assert a == b


def test_training_past_2048_tokens_matches_reference_and_crosses_packages(
        tmp_path):
    jcfg, cfg = _musicgen()
    jtr = JTrainer(jcfg, batch=1, seq_len=S, seed=0)
    tr = _port_trainer(cfg, jtr)
    want = [r.loss for r in jtr.run(2)]
    got = [r.loss for r in tr.run(2)]
    assert all(math.isfinite(x) for x in got)
    assert got[0] == pytest.approx(want[0], rel=1e-5)
    assert got[1] == pytest.approx(want[1], rel=1e-4)

    def np_state(state):
        return jax.tree_util.tree_map(
            lambda x: np.asarray(x) if isinstance(x, jax.Array) else x,
            state)
    # the port saves its step 2, repro restores it
    policy = lambda mod: mod.CheckpointPolicy(  # noqa: E731
        engine=mod.EnginePolicy(host_cache_bytes=64 << 20))
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    tm = T.CheckpointManager.from_policy(str(port_dir), policy(T),
                                         device="cpu")
    try:
        tm.save(tr.step, tr.state())
        tm.wait_for_persist()
        tm.wait_for_commit()
        assert not tm.commit_errors
    finally:
        tm.close()
    jm = J.CheckpointManager.from_policy(str(port_dir), policy(J))
    try:
        restored = jm.restore(jtr.state(), step=2)
    finally:
        jm.close()
    _assert_state_equal(np_state(restored), to_numpy_state(tr.state()))
    # repro saves its step 2, the port resumes it
    jm = J.CheckpointManager.from_policy(str(jax_dir), policy(J))
    try:
        jm.save(jtr.step, jtr.state())
        jm.wait_for_persist()
        jm.wait_for_commit()
        assert not jm.commit_errors
    finally:
        jm.close()
    tm = T.CheckpointManager.from_policy(str(jax_dir), policy(T),
                                         device="cpu")
    try:
        fresh = _port_trainer(cfg, jtr, tm)
        assert fresh.resume() == 2
    finally:
        tm.close()
    _assert_state_equal(to_numpy_state(fresh.state()),
                        np_state(jtr.state()))
    assert fresh.pipeline.state == jtr.pipeline.state
