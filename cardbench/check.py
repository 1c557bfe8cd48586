"""The comparison that decides ``correct``: the numbers a run compares,
each against its limit from ``limits/<workload>.json``.

Training (the first three steps, through the window's own call, against
:func:`cardbench.reference.train_steps` on the same weights and
batches):

- ``loss_gap``: the largest of the three steps' ``|loss - ref| / ref``;
- ``grad_gap``: the first gradient as the optimizer takes it (the
  program's from its first moment after one step, ``m / (1 - b1)``), the
  worst leaf's gap of norms, ``|norm - ref norm|`` over the larger of
  the reference's norm of that leaf and of the median leaf;
- ``grad_err``: the same first gradient, the worst leaf's norm of its
  difference from the reference's over the same denominator: a gap of
  norms moves only to second order under rounding that is not biased,
  so it cannot tell a lower precision from this one, and this can;
- ``update_gap``: the same of each leaf's change after the three steps
  (the program's float32 master copy against its start), leaving out the
  leaves whose first gradient in the reference is under a thousandth of
  the median leaf's (nought to rounding; they move by round-off alone).

The window's step ``3K + 1``, after its last save (or at three quarters
of a window without saves), against :func:`cardbench.reference.step_from`
run from the program's state before it (copied on the card as the step
fetched its batch) on the same batch:

- ``win_loss_gap``: ``|loss - ref| / ref`` of the step's recorded loss;
- ``win_grad_err``: the step's gradient as the optimizer took it (from
  the first moments before and after it), as ``grad_err``;
- ``win_update_gap``: each leaf's change of its master weight in the
  step, as ``update_gap`` with the same rule for the leaves left out.

Saves (every save the window requested, read back by
:mod:`cardbench.reader` once the window has closed, against a copy of
the state taken on the card as it was handed to the save):

- ``saves_missing``: saves requested and not committed;
- ``save_bytes_wrong``: bytes of a raw or delta tensor that differ from
  the state, every byte of a tensor missing from the save or not in the
  state, and each object (the step, the data cursor) saved wrong;
- ``int8_err``: for tensors saved as ``int8q``, the largest error over
  the bound of an int8 round trip of its row (half a quantization step
  of the row's largest magnitude plus float32 rounding), which the
  codec states; 1 is the bound.
"""

from __future__ import annotations

import json
import os
import pickle
import statistics
from typing import Any, Dict, List, Optional, Tuple

import torch

from . import reader

#: leaves whose reference gradient is under this share of the median
#: leaf's are left out of ``update_gap``
NOUGHT_SHARE = 1e-3

LIMITS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "limits")


def limits(workload: str) -> Dict[str, float]:
    with open(os.path.join(LIMITS_DIR, workload + ".json")) as f:
        return json.load(f)["limits"]


def _worst(prog: Dict[str, float], ref: Dict[str, float],
           keep: Optional[List[str]] = None) -> Tuple[float, str]:
    keys = list(ref) if keep is None else keep
    med = statistics.median(ref[k] for k in keys)
    gaps = {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
            for k in keys}
    k = max(gaps, key=gaps.get)
    return gaps[k], k


def _worst_difference(prog: Dict[str, torch.Tensor],
                      ref: Dict[str, torch.Tensor]) -> Tuple[float, str]:
    norms = {k: float(torch.linalg.vector_norm(t)) for k, t in ref.items()}
    med = statistics.median(norms.values())
    gaps = {k: float(torch.linalg.vector_norm(
        prog[k].to(t.device, torch.float32) - t)) / max(norms[k], med, 1e-30)
        for k, t in ref.items()}
    k = max(gaps, key=gaps.get)
    return gaps[k], k


def training_numbers(prog: Dict[str, Any], ref: Dict[str, Any]
                     ) -> Dict[str, Any]:
    """``prog``: ``losses``, ``grad1``, ``grad1_t`` and ``change`` as the
    program gave them; ``ref``: :func:`cardbench.reference.train_steps`'s."""
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(prog["losses"], ref["losses"]))
    grad_gap, grad_leaf = _worst(prog["grad1"], ref["grad1"])
    grad_err, err_leaf = _worst_difference(prog["grad1_t"], ref["grad1_t"])
    raw = ref["grad1_raw"]
    med = statistics.median(raw.values())
    keep = [k for k, g in raw.items() if g >= NOUGHT_SHARE * med]
    update_gap, update_leaf = _worst(prog["change"], ref["change"], keep)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "grad_err": grad_err, "update_gap": update_gap,
            "worst": {"grad": grad_leaf, "grad_err": err_leaf,
                      "update": update_leaf},
            "left_out": sorted(set(raw) - set(keep))}


def window_numbers(prog: Dict[str, Any], ref: Dict[str, Any]
                   ) -> Dict[str, Any]:
    """``prog``: :func:`cardbench.harness.window_step`'s; ``ref``:
    :func:`cardbench.reference.step_from`'s, from the same state."""
    loss_gap = abs(prog["loss"] - ref["loss"]) / abs(ref["loss"])
    grad_err, err_leaf = _worst_difference(prog["grad_t"], ref["grad_t"])
    raw = ref["grad_raw"]
    med = statistics.median(raw.values())
    keep = [k for k, g in raw.items() if g >= NOUGHT_SHARE * med]
    update_gap, update_leaf = _worst(prog["change"], ref["change"], keep)
    if loss_gap != loss_gap:
        loss_gap = float("inf")
    return {"win_loss_gap": loss_gap, "win_grad_err": grad_err,
            "win_update_gap": update_gap,
            "worst": {"grad_err": err_leaf, "update": update_leaf},
            "left_out": sorted(set(raw) - set(keep))}


def int8_bound(amax: torch.Tensor) -> torch.Tensor:
    return amax / 254 + amax * 2.0 ** -22 + 127 * 2.0 ** -126


def _row_amax(x: torch.Tensor) -> torch.Tensor:
    """Each value's row's largest magnitude (rows of 256 from the leaf's
    first value, the last one short)."""
    n = x.numel()
    pad = (-n) % reader.ROW_ELEMS
    rows = torch.cat([x.abs(), x.new_zeros(pad)]).reshape(-1,
                                                          reader.ROW_ELEMS)
    return rows.amax(dim=1).repeat_interleave(reader.ROW_ELEMS)[:n]


def save_numbers(root: str, saves: List[Dict[str, Any]], device
                 ) -> Dict[str, Any]:
    """``saves``: one ``{"step", "leaves": {path: uint8 bytes of the
    state on the card}, "objects": {name: value}}`` a save requested."""
    missing, wrong, err, n_int8 = 0, 0, 0.0, 0
    cache: Dict[int, reader.Step] = {}
    notes: List[str] = []
    for s in saves:
        step = s["step"]
        if not reader.committed(root, step):
            missing += 1
            notes.append(f"step {step} not committed")
            continue
        st = cache.get(step) or reader.Step(root, step, cache)
        cache[step] = st
        want = s["leaves"]
        for leaf in sorted(set(st.where) - set(want)):
            wrong += int(st.where[leaf].tensors[leaf]["nbytes"])
            notes.append(f"step {step}: {leaf} saved, not in the state")
        for leaf, exp in want.items():
            if leaf not in st.where:
                wrong += exp.numel()
                notes.append(f"step {step}: {leaf} missing")
                continue
            if st.codec(leaf) == "int8q":
                vals = st.where[leaf].int8_values(leaf)
                x = exp.view(torch.float32)
                got = torch.from_numpy(vals).to(device)
                if got.numel() != x.numel():
                    wrong += exp.numel()
                    continue
                n_int8 += 1
                e = ((got.double() - x.double()).abs()
                     / int8_bound(_row_amax(x)).double()).max()
                err = max(err, float(e))
                continue
            got = torch.from_numpy(st.tensor_bytes(leaf)).to(device)
            if got.numel() != exp.numel():
                wrong += exp.numel()
                notes.append(f"step {step}: {leaf} of {got.numel()} bytes")
                continue
            bad = int((got != exp).sum())
            if bad:
                notes.append(f"step {step}: {leaf} {bad} bytes differ")
            wrong += bad
        for name, value in s["objects"].items():
            f = st.objects.get(name)
            ok = f is not None and pickle.loads(f.object_bytes(name)) \
                == value
            if not ok:
                wrong += 1
                notes.append(f"step {step}: object {name} wrong")
    out = {"saves_missing": missing, "save_bytes_wrong": wrong,
           "notes": notes[:8]}
    if n_int8:
        out["int8_err"] = err
    return out


def judge(numbers: Dict[str, float], lim: Dict[str, float]
          ) -> Tuple[bool, List[Tuple[str, float, float]]]:
    """``(correct, [(name, number, limit), ...])``: every number at or
    under its limit; a number without a limit, or a limit without its
    number, is not correct."""
    rows = []
    ok = True
    for name in sorted(set(lim) | set(numbers)):
        value = numbers.get(name, float("nan"))
        limit = lim.get(name, float("nan"))
        good = bool(value <= limit)
        ok = ok and good
        rows.append((name, value, limit))
    return ok, rows
