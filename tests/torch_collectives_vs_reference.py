"""The port's collective bytes by kind beside the reference's, for one
reduced config on a (2, 2) mesh (a script, not a test: no gate, since
GSPMD and ``DTensor`` choose different collectives).

The port's side is ``repro_torch.launch.dryrun`` in this process: the
step traced on ``DTensor``s over a fake process group, rank 0's local
program counted. The reference's side is ``repro.launch.dryrun`` in a
subprocess of its own, with 4 forced host devices
(``REPRO_DRYRUN_DEVICES=4``) and ``REPRO_DRYRUN_MESH=2,2``: the per-device
HLO's collectives (``collective_bytes``). Both run the llama3.2-1b smoke
variant (2 layers, d_model 256) at 8 x 128 tokens for train and
prefill, and a 128-token cache for decode, in ``2d`` mode. Usage::

    PYTHONPATH=src JAX_PLATFORMS=cpu python \\
        tests/torch_collectives_vs_reference.py [--arch llama3.2-1b]

It prints one markdown table: by step, each kind's count and bytes in
each package, and FLOPs a device.
"""

import argparse
import json
import os
import subprocess
import sys

SHAPES = {"train_4k": (128, 8), "prefill_32k": (128, 8),
          "decode_32k": (128, 8)}
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")

REFERENCE = r"""
import dataclasses, json, sys
from repro.configs import INPUT_SHAPES, get_config, smoke_variant
from repro.launch import dryrun
arch, shapes = sys.argv[1], json.loads(sys.argv[2])
dryrun.get_config = lambda name, **kw: dataclasses.replace(
    smoke_variant(get_config(name)), **kw)
out = {}
for name, (seq, batch) in shapes.items():
    dryrun.INPUT_SHAPES[name] = dataclasses.replace(
        INPUT_SHAPES[name], seq_len=seq, global_batch=batch)
    rec = dryrun.run_dryrun(arch, name, verbose=False)
    roof = rec["roofline"]
    out[name] = {"collectives": roof["collectives"],
                 "flops": roof["per_device"]["flops"]}
print("REF" + json.dumps(out))
"""


def reference(arch: str) -> dict:
    env = dict(os.environ, REPRO_DRYRUN_DEVICES="4", REPRO_DRYRUN_MESH="2,2",
               JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", REFERENCE, arch,
                          json.dumps(SHAPES)], env=env, check=True,
                         capture_output=True, text=True)
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("REF")]
    return json.loads(line[-1][3:])


def port(arch: str) -> dict:
    import dataclasses

    from repro_torch.configs import INPUT_SHAPES, get_config, smoke_variant
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_abstract_mesh
    cfg = smoke_variant(get_config(arch))
    mesh = make_abstract_mesh((2, 2), ("data", "model"))
    out = {}
    for name, (seq, batch) in SHAPES.items():
        shape = dataclasses.replace(INPUT_SHAPES[name], seq_len=seq,
                                    global_batch=batch)
        kvb = min(4096, max(1024, seq // 8))
        rec = dryrun.dryrun_record(
            dataclasses.replace(cfg, attn_kv_block=kvb), shape, mesh)
        roof = rec["roofline"]
        out[name] = {"collectives": roof["collectives"],
                     "flops": roof["per_device"]["flops"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="llama3.2-1b")
    args = ap.parse_args(argv)
    ref, got = reference(args.arch), port(args.arch)
    print(f"| step | kind | port count | port bytes | reference count | "
          f"reference bytes |")
    print("|---|---|---|---|---|---|")
    for name in SHAPES:
        for kind in KINDS:
            p, r = got[name]["collectives"], ref[name]["collectives"]
            print(f"| {name} | {kind} | {p['counts'][kind]} | "
                  f"{p['by_kind'][kind]} | {r['counts'][kind]} | "
                  f"{r['by_kind'][kind]} |")
        print(f"| {name} | FLOPs a device | {got[name]['flops']:.6g} | | "
              f"{ref[name]['flops']:.6g} | |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
