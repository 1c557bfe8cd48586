"""Checkpoints of every block type of slice 14 across the two packages.

A trainer of one config holding every new block type (``full_moe`` with
the shared expert, the RG-LRU's ``rec``, RWKV6's ``rwkv``) and the
prefix-LM's prefix, at llama4-maverick's ``smoke_variant`` widths in
bf16, takes one step in each package (the port's from the JAX trainer's
initial params, ``device="cpu"``). The port's step saved restores bit for
bit through ``repro`` (params and AdamW state), and ``repro``'s resumes
bit for bit in the port, the data cursor included.
"""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as J  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_variant as jsmoke  # noqa: E402
from repro.training.loop import Trainer as JTrainer  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.convert import from_numpy_state, to_numpy_state  # noqa
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.training.loop import Trainer  # noqa: E402

from test_torch_zoo_training import _assert_state_equal  # noqa: E402

#: every new block type in one stack, with the prefix
MIXED = {"layer_groups": ((("full_moe", "rec", "rwkv"), 1),),
         "n_layers": 3, "n_prefix_embeds": 4}


def _mixed():
    jcfg = dataclasses.replace(jsmoke(jget_config(
        "llama4-maverick-400b-a17b")), **MIXED)
    assert jcfg.shared_expert and jcfg.dtype == "bfloat16"
    return jcfg, ModelConfig(**{f.name: getattr(jcfg, f.name)
                                for f in dataclasses.fields(ModelConfig)})


def _np_state(state):
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) if isinstance(x, jax.Array) else x, state)


def test_new_block_types_cross_packages_bit_exactly(tmp_path):
    jcfg, cfg = _mixed()
    jtr = JTrainer(jcfg, batch=1, seq_len=32, seed=0)
    jtr.run(1)
    tr = Trainer(cfg, batch=1, seq_len=32, device="cpu")
    tr.params = jax.tree_util.tree_map(
        lambda t: t.requires_grad_(True),
        from_numpy_state(jax.tree_util.tree_map(np.asarray, jtr.params),
                         "cpu"))
    tr.opt_state = adamw.init_opt_state(tr.params)
    tr.run(1)
    moe_block, rec_block, rwkv_block = tr.params["groups"][0]
    assert "shared" in moe_block["moe"] and "rec" in rec_block \
        and {"tmix", "cmix"} <= set(rwkv_block)
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
        restored = jm.restore(jtr.state(), step=1)
    finally:
        jm.close()
    _assert_state_equal(_np_state(restored), to_numpy_state(tr.state()))
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
        fresh = Trainer(cfg, batch=1, seq_len=32, manager=tm, device="cpu")
        assert fresh.resume() == 1
    finally:
        tm.close()
    _assert_state_equal(to_numpy_state(fresh.state()),
                        _np_state(jtr.state()))
    assert fresh.pipeline.state == jtr.pipeline.state
    assert np.isfinite([r.loss for r in tr.records + jtr.records]).all()
