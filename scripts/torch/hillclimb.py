"""Perf hillclimb runner for the port: trace variants of one
(arch × shape) pair with the dry run and compare roofline terms against
the baseline.

The port's counterpart of ``scripts/hillclimb.py``:

    PYTHONPATH=src python scripts/torch/hillclimb.py --arch llama3.2-1b \\
        --shape decode_32k --label kvblock2048 --set attn_kv_block=2048

Each invocation runs ONE variant of ``python -m repro_torch.launch.dryrun``
in a fresh process and appends the record to
``experiments/perf/torch_<arch>_<shape>.jsonl`` (``--out-dir``).
``--label baseline`` (or ``--mode tp_zero1 --label paper``) records
reference points. The dry run needs no card.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--label", required=True)
    ap.add_argument("--mode", default="2d")
    ap.add_argument("--set", action="append", default=[])
    ap.add_argument("--no-donate", action="store_true")
    ap.add_argument("--hypothesis", default="",
                    help="recorded alongside the result")
    ap.add_argument("--out-dir", default=os.path.join(
        ROOT, "experiments", "perf"))
    args = ap.parse_args(argv)

    out_dir = args.out_dir
    os.makedirs(out_dir, exist_ok=True)
    tmp_json = os.path.join(
        out_dir, f".torch_{args.arch}_{args.shape}_{args.label}.json")

    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", args.arch, "--shape", args.shape,
           "--mode", args.mode, "--out", tmp_json]
    for s in args.set:
        cmd += ["--set", s]
    if args.no_donate:
        cmd += ["--no-donate"]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    r = subprocess.run(cmd, env=env, cwd=ROOT)
    if r.returncode != 0:
        print(f"variant {args.label} FAILED to trace", file=sys.stderr)
        return 1

    with open(tmp_json) as f:
        rec = json.load(f)
    os.remove(tmp_json)
    rec["label"] = args.label
    rec["hypothesis"] = args.hypothesis
    log = os.path.join(out_dir, f"torch_{args.arch}_{args.shape}.jsonl")
    with open(log, "a") as f:
        f.write(json.dumps(rec) + "\n")

    # print comparison against every prior entry
    with open(log) as f:
        entries = [json.loads(line) for line in f]
    base = entries[0]
    bt = base["roofline"]["terms"]
    print(f"\n{'label':<22}{'compute':>10}{'memory':>10}{'collective':>12}"
          f"{'dominant':<14}{'Δdom vs base':>13}")
    for e in entries:
        t = e["roofline"]["terms"]
        dom = e["roofline"]["dominant"]
        delta = (t[base["roofline"]["dominant"]]
                 / max(bt[base["roofline"]["dominant"]], 1e-12) - 1) * 100
        print(f"{e['label']:<22}{t['compute_s']:>10.3f}{t['memory_s']:>10.3f}"
              f"{t['collective_s']:>12.3f}  {dom.replace('_s',''):<12}"
              f"{delta:>+12.1f}%")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
