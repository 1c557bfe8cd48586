"""Profile for dry-run hillclimbing: trace one (arch × shape) step as the
dry run does and print its largest-result operators, the total result
bytes by operator kind and the traced FLOPs and bytes.

The port's counterpart of ``scripts/hlo_top_ops.py``:

    PYTHONPATH=src python scripts/torch/top_ops.py --arch llama3.2-1b \\
        --shape train_4k [--mode 2d] [--top 25] [--set k=v ...]

The reference compiles the step and reads the HLO's instructions; the
port traces it on fake tensors (``repro_torch.launch.dryrun.run_dryrun``:
the production mesh, or ``REPRO_DRYRUN_MESH`` such as ``2,2``, the fake
process group, the same ``attn_kv_block`` rule) and reads the dry-run
counter's record of each operator it counts: rank 0's local program,
views and DTensor's bookkeeping left out. The FLOPs and bytes printed
last are the dry-run record's ``per_device`` figures. It needs no card.
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: kinds printed in the by-kind table, as the reference's
BY_KIND_TOP = 15


def rows(record: dict, top: int) -> list:
    """The ``top`` largest-result operators of a record with ``ops``:
    ``(bytes, op, name, type)``, largest first (ties by trace order);
    operators with no result bytes are left out, as the reference's."""
    out = [(o["bytes"], o["op"], o["name"], o["type"])
           for o in record["ops"] if o["bytes"]]
    out.sort(key=lambda r: -r[0])
    return out[:top]


def by_kind(record: dict) -> list:
    """``(kind, count, result bytes)`` of every operator kind, most bytes
    first."""
    out = [(k, n, b) for k, (n, b) in record["op_profile"].items()]
    out.sort(key=lambda r: -r[2])
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mode", default="2d")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--set", action="append", default=[])
    args = ap.parse_args(argv)

    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.launch import dryrun

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        overrides[k] = dryrun._parse_value(v)
    rec = dryrun.run_dryrun(args.arch, args.shape, mode=args.mode,
                            overrides=overrides, verbose=False,
                            record_ops=True)
    if rec.get("skipped"):
        print(f"SKIPPED: {rec['reason']}")
        return rec
    print(f"[{args.arch} x {args.shape} x {rec['mesh']}] {args.mode}, "
          f"{len(rec['ops'])} operators traced in {rec['trace_s']:.1f} s")
    print("== top ops by result bytes ==")
    for b, op, name, t in rows(rec, args.top):
        print(f"{b / 1e6:10.1f} MB  {op:<38} {name[:40]:<42} {t[:70]}")
    print(f"\n== total result bytes by op kind (top {BY_KIND_TOP}) ==")
    for kind, n, b in by_kind(rec)[:BY_KIND_TOP]:
        print(f"{b / 1e9:10.2f} GB  {kind} ({n})")
    per = rec["roofline"]["per_device"]
    print(f"\ncost_analysis: flops={per['flops']:.3e} "
          f"bytes={per['bytes']:.3e} (per device: {per['flops']!r} FLOPs, "
          f"{per['bytes']!r} bytes)")
    return rec


if __name__ == "__main__":
    main()
