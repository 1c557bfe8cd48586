"""The readings the limits of ``limits/<workload>.json`` are set from, on
the chip at the cell's own size: ``python3 cardbench/calibrate.py
--workload <name> --seeds <a>-<b> --seconds <s>`` runs the cell (a window
of ``--seconds``, its saves and its window step as in a benchmark run)
once a seed and prints one JSON line a seed with the numbers of the
program (the lower readings), of the control (the reference in float8
products, put in the program's place) and of two planted faults (the
reference's loss taken over half of the batch; the program's reported
loss altered by 1 %), each against the float32 reference.
``--summarize <file>`` reads such lines and prints each number's lower
and upper reading and the limit they give. The benchmark's own runs do
not run it."""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0:1] = [ROOT, os.path.join(ROOT, "src")]

#: a planted fault's least reading that sets an upper one, as a multiple
#: of the lower; the control's; a state left unchanged (it reads 1 on
#: the update's numbers and needs no run)
FAULT_X, CONTROL_X, UNCHANGED_X = 10.0, 3.0, 3.0
#: the limit's place between the lower and the upper reading, in the
#: exponent (more room above the lower than below the upper)
LIMIT_AT = 0.6


def readings(cell, seed: int, seconds: float, device) -> dict:
    from cardbench import check, data, harness, reference
    out = harness.run_cell(cell, seed, seconds, False, device,
                           time.perf_counter(), keep=True)
    it = out.pop("internals")
    tr = cell["traffic_spec"]
    prog, ref = it["prog"], it["ref"]
    ctrl = harness.reference_steps(cell, seed, device,
                                   mm=reference.fp8_matmul)
    half = harness.reference_steps(cell, seed, device, half_batch=True)
    # the loss the program reports altered where it is produced
    altered = dict(prog, losses=[x * 1.01 for x in prog["losses"]])
    batch = data.Batches(cell["cfg"], tr["batch"], tr["seq_len"],
                         seed).at(it["ws_batch"], device)

    def win(**kw):
        return reference.step_from(cell["cfg"], tr["adamw"], it["ws_state"],
                                   it["ws_n"], batch, **kw)
    w_alt = dict(it["ws_prog"], loss=it["ws_prog"]["loss"] * 1.01)
    res = {"seed": seed, "correct": out["correct"], "steps": out["steps"],
           "window_step": it["ws_n"]}
    for name, first, step in (
            ("program", prog, it["ws_prog"]),
            ("control", ctrl, win(mm=reference.fp8_matmul)),
            ("half_batch", half, win(half_batch=True)),
            ("altered_loss", altered, w_alt)):
        tn = check.training_numbers(first, ref)
        wn = check.window_numbers(step, it["ws_ref"])
        res[name] = {**{k: tn[k] for k in harness.TRAINING_NUMBERS},
                     **{k: wn[k] for k in harness.WINDOW_NUMBERS},
                     "worst": {**tn["worst"],
                               **{"win_" + k: v
                                  for k, v in wn["worst"].items()}}}
    return res


def summarize(lines, sound=()) -> dict:
    """Each number's ``lower`` (the program's largest, here and in
    ``sound``, the checks of the benchmark's own sound runs), ``upper``
    (the least of the control's smallest, where 3x the lower or more,
    and each fault's smallest, where 10x or more; a state left unchanged
    reads 1 on the update's numbers) and ``limit``, two significant
    digits of ``lower * (upper / lower) ** 0.6``."""
    from cardbench import harness
    out = {}
    for k in harness.TRAINING_NUMBERS + harness.WINDOW_NUMBERS:
        lower = max([r["program"][k] for r in lines]
                    + [r[k] for r in sound if k in r])
        cands = {}
        c = min(r["control"][k] for r in lines)
        if c >= CONTROL_X * lower:
            cands["control"] = c
        for f in ("half_batch", "altered_loss"):
            v = min(r[f][k] for r in lines)
            if v >= FAULT_X * lower:
                cands[f] = v
        if k.endswith("update_gap") and 1.0 >= UNCHANGED_X * lower:
            cands["unchanged"] = 1.0
        row = {"lower": lower, "control_min": c,
               **{f + "_min": min(r[f][k] for r in lines)
                  for f in ("half_batch", "altered_loss")}}
        if cands:
            src = min(cands, key=cands.get)
            upper = cands[src]
            row.update(upper=upper, upper_from=src,
                       limit=float(f"{lower * (upper / lower) ** LIMIT_AT:.2g}"))
        out[k] = row
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload")
    ap.add_argument("--seeds", help="first-last, inclusive")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--summarize", nargs="+", help="files of this "
                    "script's lines, then (optional) result lines of "
                    "the benchmark's sound runs of the same cells")
    args = ap.parse_args()
    if args.summarize:
        lines, sound = [], []
        for path in args.summarize:
            with open(path) as f:
                for x in f:
                    d = json.loads(x) if x.startswith("{") else None
                    if d and "program" in d:
                        lines.append(d)
                    elif d and "checks" in d:
                        sound.append({k: v["value"]
                                      for k, v in d["checks"].items()})
        print(json.dumps(summarize(lines, sound), indent=1))
        return 0
    from cardbench import harness
    cell = harness.cell_spec(args.workload)
    lo, hi = (int(x) for x in args.seeds.split("-"))
    for seed in range(lo, hi + 1):
        t0 = time.perf_counter()
        r = readings(cell, seed, args.seconds, "cuda")
        r["seconds"] = time.perf_counter() - t0
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
