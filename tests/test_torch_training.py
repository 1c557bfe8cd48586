"""The port's training entry point: the two-phase ``Trainer`` under the
manager, exact resume, and the ``repro_torch.launch.train`` CLI.

All on ``device="cpu"`` at ``smoke_variant(llama3.2-1b)`` (2 layers,
d_model 256), batch 2 x 32 tokens.

* A run resumed from a *delta* step reproduces the uninterrupted loss
  trajectory bit for bit (the port's version of
  ``tests/test_delta_faults.py::test_exact_resume_from_delta_step``).
* Under the mixed policy (params delta-routed, fp32 optimizer state
  ``quantized``) params and the data cursor restore exactly, so the first
  loss after resume equals the uninterrupted run's bit for bit; master,
  m and v come back within half a quantization step of what was saved,
  so later losses are only finite and close (``rtol=1e-2``: the
  dequantized master moves every weight by up to ``row amax / 254``).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, smoke_variant
from repro_torch.core import (CheckpointManager, CheckpointPolicy,
                              DeltaPolicy, EnginePolicy,
                              StateProviderRegistry)
from repro_torch.core.tree import leaves
from repro_torch.kernels import quantize as tq
from repro_torch.launch import train as launch_train
from repro_torch.obs import trace as obs
from repro_torch.training.loop import Trainer

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CFG = smoke_variant(get_config("llama3.2-1b"))
BATCH, SEQ = 2, 32


def _trainer(manager=None) -> Trainer:
    return Trainer(CFG, batch=BATCH, seq_len=SEQ, manager=manager,
                   device="cpu")


def _mixed_policy() -> CheckpointPolicy:
    """Params delta-routed under a keyframe every 2 saves; fp32 optimizer
    state quantized; small chunks so each leaf crosses several encodes."""
    return CheckpointPolicy(
        engine=EnginePolicy(host_cache_bytes=1 << 26, chunk_bytes=1 << 16),
        delta=DeltaPolicy(keyframe_every=2),
        providers=(StateProviderRegistry()
                   .add_rule(provider="quantized", domain="optimizer",
                             dtype="float32")
                   .add_rule(provider="auto")))


@pytest.fixture(scope="module")
def reference_losses():
    """An uninterrupted 6-step run without a manager."""
    return [r.loss for r in _trainer().run(6)]


def _train_and_resume(tmp_path, policy):
    """4 steps with saves at 2 (keyframe) and 4 (delta), then a fresh
    manager and trainer resume step 4. Returns (the first trainer, the
    resumed trainer, its manager)."""
    mgr = CheckpointManager.from_policy(str(tmp_path), policy, device="cpu")
    tr = _trainer(mgr)
    tr.run(4, ckpt_interval=2)
    mgr.wait_for_commit()
    assert mgr.repository.manifest(4).meta["delta"]["keyframe"] is False
    mgr.close()
    mgr2 = CheckpointManager.from_policy(str(tmp_path), device="cpu")
    tr2 = _trainer(mgr2)
    assert tr2.resume() == 4
    return tr, tr2, mgr2


def _assert_int8_round_trip(got: torch.Tensor, saved: torch.Tensor,
                            what: str) -> None:
    """``got`` is bit for bit the plain dequantize of the plain quantize
    of ``saved`` (rows of 256 from the leaf's first value, the tail
    zero-padded), and within half a quantization step of it: ``amax /
    254``, plus the fp32 rounding of the scale, the quotient and the
    product (``2^-22 * amax``), plus the whole value in a row whose scale
    the reference flushes (``amax < 127 * 2^-126``)."""
    x = saved.reshape(-1)
    pad = (-x.numel()) % tq.ROW_ELEMS
    rows = torch.cat([x, x.new_zeros(pad)]).reshape(-1, tq.ROW_ELEMS)
    body, _ = tq.quantize_checksum_plain(rows)
    want, _ = tq.dequantize_checksum_plain(body, rows.shape[0])
    want = want.reshape(-1)[:x.numel()]
    assert torch.equal(got.reshape(-1).view(torch.int32),
                       want.view(torch.int32)), what
    amax = rows.abs().amax(dim=1).repeat_interleave(tq.ROW_ELEMS)
    amax = amax[:x.numel()].double()
    err = (got.reshape(-1).double() - x.double()).abs()
    bound = amax / 254 + amax * 2.0 ** -22 + 127 * 2.0 ** -126
    assert bool((err <= bound).all()), what


def test_exact_resume_from_delta_step(tmp_path, reference_losses):
    tr, tr2, mgr2 = _train_and_resume(
        tmp_path, CheckpointPolicy(delta=DeltaPolicy(keyframe_every=2)))
    try:
        assert [r.loss for r in tr.records] == reference_losses[:4]
        assert all(p.requires_grad for p in leaves(tr2.params))
        resumed = [r.loss for r in tr2.run(2)]
    finally:
        mgr2.close()
    np.testing.assert_array_equal(np.asarray(resumed, np.float64),
                                  np.asarray(reference_losses[4:],
                                             np.float64))


def test_resume_under_quantized_optimizer_state(tmp_path, reference_losses):
    tr, tr2, mgr2 = _train_and_resume(tmp_path, _mixed_policy())
    try:
        for a, b in zip(leaves(tr2.params), leaves(tr.params)):
            assert a.dtype == b.dtype and torch.equal(a, b)
        assert torch.equal(tr2.opt_state["count"], tr.opt_state["count"])
        for key in ("master", "m", "v"):
            for a, b in zip(leaves(tr2.opt_state[key]),
                            leaves(tr.opt_state[key])):
                _assert_int8_round_trip(a, b, key)
        assert tr2.pipeline.state == tr.pipeline.state
        resumed = [r.loss for r in tr2.run(2)]
    finally:
        mgr2.close()
    assert resumed[0] == reference_losses[4]
    assert np.isfinite(resumed[1])
    assert resumed[1] == pytest.approx(reference_losses[5], rel=1e-2)


def test_trainer_records_and_spans(tmp_path):
    """The IterationRecord fields, the loop's spans and the int8 encode's,
    and the exit drain folded into the last record's stall."""
    with CheckpointManager.from_policy(str(tmp_path), _mixed_policy(),
                                       device="cpu") as mgr:
        tr = _trainer(mgr)
        with obs.tracing() as tracer:
            recs = tr.run(3, ckpt_interval=2)
        names = {e["name"] for e in tracer.events()}
        assert {"train.iteration", "ckpt.capture_barrier", "ckpt.exit_drain",
                "encode.int8"} <= names
        assert [r.step for r in recs] == [1, 2, 3]
        assert [r.ckpt_requested for r in recs] == [False, True, False]
        assert all(r.grad_s > 0 and r.iter_s >= r.grad_s for r in recs)
        assert recs[1].prologue_s > 0 and recs[0].prologue_s == 0
        assert recs[-1].ckpt_stall_s >= tr.exit_drain_s >= 0
        assert mgr.latest_step() == 2


def test_trainer_device_is_explicit():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="is_available"):
        Trainer(CFG, batch=BATCH, seq_len=SEQ)


def test_launcher_refuses_unported_engines_and_missing_card(tmp_path):
    """The three baseline engines train and resume through the launcher
    on the CPU; an engine outside the four the paper compares is refused,
    and so is the card on a host without one."""
    for engine in ("sync", "snapshot", "datastates-old"):
        argv = ["--arch", "llama3.2-1b", "--smoke", "--batch", "2",
                "--seq-len", "16", "--ckpt-interval", "2", "--device",
                "cpu", "--engine", engine, "--ckpt-dir",
                str(tmp_path / engine)]
        assert launch_train.main(argv + ["--steps", "2"]) == 0
        rec = str(tmp_path / f"{engine}.json")
        assert launch_train.main(argv + ["--steps", "1", "--resume",
                                         "--json", rec]) == 0
        with open(rec) as f:
            assert [r["step"] for r in json.load(f)] == [3]
    with pytest.raises(SystemExit):
        launch_train.main(["--arch", "llama3.2-1b", "--smoke",
                           "--engine", "torch.save", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            launch_train.main(["--arch", "llama3.2-1b", "--smoke",
                               "--steps", "1"])


def test_launcher_trains_and_resumes_on_the_cpu(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    cmd = [sys.executable, "-m", "repro_torch.launch.train",
           "--arch", "llama3.2-1b", "--smoke", "--steps", "4",
           "--ckpt-interval", "2", "--device", "cpu", "--ckpt-dir", ckpt]
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, (out.stdout, out.stderr)
    assert "device=cpu steps=4" in out.stdout
    rec = str(tmp_path / "records.json")
    assert launch_train.main(cmd[3:] + ["--resume", "--steps", "1",
                                        "--json", rec]) == 0
    with open(rec) as f:
        assert [r["step"] for r in json.load(f)] == [5]
