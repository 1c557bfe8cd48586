"""The comparison that decides ``correct`` against the faults a cell can
have, at the CPU size with each cell's own limits: a sound run comes out
correct; the control (the reference in float8 products, put in the
program's place) and each planted fault do not. (``sc2-train-16k`` at
the CPU size reads an ``update_gap`` of 0.07-0.15 from its ``attn/bk``
leaf, whose gradient is small at widths of 64-128, above the limit its
own widths set; its sound run is judged on the chip. The musicgen cells'
update numbers read 0.003-0.034 at the CPU size over eight seeds, from
``attn/bk`` and other small leaves, against limits of 0.024-0.032 set at
the chip's widths: the sound runs here hold one seed.)"""

import time

import pytest

from cardbench import check, harness, reference
from cardbench.tests.small import small_cell

SEED = 3_000_000_019


def _run(workload, prepare=None, in_window=None):
    return harness.run_cell(small_cell(workload), SEED, 0.2, False, "cpu",
                            time.perf_counter(), prepare, in_window)


def _unchanged(trainer):
    trainer.update_step = lambda params, opt_state, grads: (params,
                                                            opt_state)


def _half_batch(trainer):
    """Half of the batch left out (of the sequence, where the batch is one
    row), the mean taken over the rest."""
    step = trainer.grad_step

    def half(params, batch):
        B, S = batch["tokens"].shape[:2]
        if B > 1:
            return step(params, {k: v[:B // 2] for k, v in batch.items()})
        return step(params, dict(batch, tokens=batch["tokens"][:, :S // 2]))
    trainer.grad_step = half


def _altered_loss(trainer):
    step = trainer.grad_step

    def altered(params, batch):
        grads, loss = step(params, batch)
        return grads, loss * 1.01
    trainer.grad_step = altered


@pytest.mark.parametrize("workload", ["mg-ckpt-lazy", "mg-ckpt-mixed",
                                      "mg-train"])
def test_sound_run_correct(workload):
    out = _run(workload)
    assert out["correct"], out["rows"]


@pytest.mark.parametrize("workload", ["mg-ckpt-lazy", "sc2-train-16k"])
@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered_loss])
def test_training_fault_fails(fault, workload):
    out = _run(workload, fault)
    assert not out["correct"], out["rows"]


@pytest.mark.parametrize("workload", ["mg-ckpt-lazy", "mg-ckpt-mixed",
                                      "mg-train"])
@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered_loss])
def test_window_fault_fails(fault, workload):
    """The fault planted after set-up, so that only the window's step
    can show it."""
    out = _run(workload, in_window=fault)
    assert not out["correct"], out["rows"]
    rows = {r[0]: (r[1], r[2]) for r in out["rows"]}
    assert all(v <= lim for k, (v, lim) in rows.items()
               if k in harness.TRAINING_NUMBERS), rows


@pytest.mark.parametrize("workload", ["mg-ckpt-lazy", "mg-ckpt-mixed"])
def test_altered_save_fails(monkeypatch, workload):
    """One byte of one tensor of the window's saves flipped as a flush
    lane writes it."""
    from repro_torch.core import layout
    write = layout.FileWriter.write_at
    done = []

    def flip(self, offset, data):
        if not done and len(data) > 16 and "/ckpt/" in self.path:
            b = bytearray(data)
            b[7] ^= 0x40
            data = bytes(b)
            done.append(offset)
        write(self, offset, data)
    monkeypatch.setattr(layout.FileWriter, "write_at", flip)
    out = _run(workload)
    assert done and not out["correct"]
    assert dict((r[0], r[1]) for r in out["rows"])["save_bytes_wrong"] > 0


@pytest.mark.parametrize("workload", ["mg-ckpt-lazy", "sc2-train-16k"])
def test_control_fails(workload):
    """The reference in float8 products in the program's place."""
    cell = small_cell(workload)
    ref = harness.reference_steps(cell, SEED, "cpu")
    ctrl = harness.reference_steps(cell, SEED, "cpu",
                                   mm=reference.fp8_matmul)
    nums = check.training_numbers(ctrl, ref)
    names = harness.TRAINING_NUMBERS
    correct, rows = check.judge({k: nums[k] for k in names},
                                {k: cell["limits"][k] for k in names})
    assert not correct, rows
