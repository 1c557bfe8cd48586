"""Generate the §Dry-run and §Roofline sections for the port from its dry
run records.

The port's counterpart of ``scripts/experiments_report.py``. It reads
``experiments/dryrun_torch/<arch>_<shape>_<pod|multipod>.json`` (``--dir``),
each written by

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch A --shape S \\
        [--multi-pod] --out experiments/dryrun_torch/A_S_pod.json

and prints markdown:

    PYTHONPATH=src python scripts/torch/experiments_report.py > sections.md

Where the reference reads ``compile_s`` it reads ``trace_s`` (the port
traces the step once on fake tensors; nothing is compiled). The bandwidth,
the peak rate and the memory lower bound come from each record
(``roofline.hw``, ``roofline.terms.memory_lb_s``), never from a constant
of this script.
"""

import argparse
import json
import os

SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
ARCHS = ["dbrx-132b", "rwkv6-7b", "starcoder2-7b", "recurrentgemma-2b",
         "musicgen-medium", "gemma3-27b", "llama3.2-1b", "paligemma-3b",
         "llama4-maverick-400b-a17b", "command-r-35b", "llama2-7b"]
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(ROOT, "experiments", "dryrun_torch")


def load(directory, arch, shape, pod):
    p = os.path.join(directory, f"{arch}_{shape}_{pod}.json")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)


def mem_lb(r):
    """The record's own memory lower bound (arguments + outputs −
    aliases over the record's HBM rate), seconds."""
    return r["roofline"]["terms"].get("memory_lb_s")


def fmt(x, unit="ms"):
    if x is None:
        return "—"
    v = x * 1e3
    return f"{v:,.1f}" if v < 10_000 else f"{v:,.0f}"


def dryrun_section(directory):
    print("## §Dry-run — trace proof on the production meshes\n")
    print("Every (architecture × input shape) step traced once on fake"
          " tensors (`python -m repro_torch.launch.dryrun`) against BOTH"
          " production meshes of virtual devices: single-pod `16×16 (data,"
          " model)` = 256 devices and multi-pod `2×16×16 (pod, data,"
          " model)` = 512. ✓ = traced; `skip` = documented long-context"
          " skip; numbers are trace seconds.\n")
    print("| arch | shape | 16×16 | 2×16×16 | per-dev GiB (512-device) |")
    print("|---|---|---|---|---|")
    n_ok = n_skip = n_miss = 0
    for a in ARCHS:
        for s in SHAPES:
            rp = load(directory, a, s, "pod")
            rm = load(directory, a, s, "multipod")
            cells = []
            byt = "—"
            for r in (rp, rm):
                if r is None:
                    cells.append("⏳")
                    n_miss += 1
                elif r.get("skipped"):
                    cells.append("skip")
                    n_skip += 1
                else:
                    cells.append(f"✓ {r['trace_s']:.0f}s")
                    n_ok += 1
            if rm and not rm.get("skipped"):
                m = rm["roofline"]["memory"]
                tot = (m.get("argument_size_in_bytes", 0)
                       + m.get("temp_size_in_bytes", 0)
                       + m.get("output_size_in_bytes", 0)
                       - m.get("alias_size_in_bytes", 0))
                byt = f"{tot/2**30:.2f}"
            print(f"| {a} | {s} | {cells[0]} | {cells[1]} | {byt} |")
    print(f"\n**{n_ok} traces OK, {n_skip} skips documented, "
          f"{n_miss} pending.** Skips: `long_500k` on pure full-attention"
          " archs (dbrx, musicgen, llama3.2, paligemma, command-r) — "
          "sub-quadratic attention required; runs on SSM/hybrid/windowed"
          " archs (rwkv6, recurrentgemma, starcoder2, gemma3, llama4).\n")


def _hw_text(directory):
    for a in ARCHS:
        for s in SHAPES:
            r = load(directory, a, s, "pod")
            if r and not r.get("skipped"):
                hw = r["roofline"]["hw"]
                return (f"{hw.get('card', 'card')} constants (from the "
                        f"records): {hw['peak_flops'] / 1e12:,.0f} TFLOP/s "
                        f"bf16, {hw['hbm_bw'] / 1e9:,.0f} GB/s HBM, "
                        f"{hw['link_bw'] / 1e9:,.0f} GB/s a link.")
    return "No traced record yet."


def roofline_section(directory):
    print("## §Roofline — single-pod (16×16, 256 devices) terms\n")
    print(_hw_text(directory) +
          " `mem_ub` = bytes every traced operator reads and writes (an"
          " upper bound); `mem_lb` = args+outputs−aliases over the"
          " record's HBM rate (guaranteed traffic). `dominant` uses the"
          " conservative ub; `eff` = MODEL_FLOPS/traced FLOPs"
          " (useful-compute fraction).\n")
    print("| arch | shape | compute | mem_lb | mem_ub | collective | "
          "dominant | eff | note |")
    print("|---|---|---|---|---|---|---|---|---|")
    for a in ARCHS:
        for s in SHAPES:
            r = load(directory, a, s, "pod")
            if r is None:
                print(f"| {a} | {s} | ⏳ | | | | | | |")
                continue
            if r.get("skipped"):
                print(f"| {a} | {s} | — | — | — | — | skip | — | "
                      f"full-attention arch |")
                continue
            t = r["roofline"]["terms"]
            lb = mem_lb(r)
            dom = r["roofline"]["dominant"].replace("_s", "")
            eff = r["roofline"]["useful_flops_ratio"]
            # realistic bottleneck: max(compute, mem_lb, collective)
            cand = {"compute": t["compute_s"], "memory": lb or 0,
                    "collective": t["collective_s"]}
            real = max(cand, key=cand.get)
            note = f"lb-dominant: {real}"
            print(f"| {a} | {s} | {fmt(t['compute_s'])} | {fmt(lb)} | "
                  f"{fmt(t['memory_s'])} | {fmt(t['collective_s'])} | "
                  f"{dom} | {eff:.2f} | {note} |")
    print()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default=DEFAULT_DIR,
                    help="directory of the port's dry run records")
    args = ap.parse_args(argv)
    dryrun_section(args.dir)
    roofline_section(args.dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
