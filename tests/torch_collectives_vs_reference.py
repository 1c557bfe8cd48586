"""The port's per-device work beside the reference's, from both dry runs:
FLOPs a device and collective bytes by kind (a script, not a test; the
test that holds the FLOPs is ``tests/test_torch_tensor_parallel.py``,
which uses these functions).

The port's side is ``repro_torch.launch.dryrun.dryrun_record`` in this
process: the step traced on ``DTensor``s over a fake process group, rank
0's local program counted. The reference's side is
``repro.launch.dryrun.run_dryrun`` in a subprocess of its own, with as
many forced host devices as the mesh has (``REPRO_DRYRUN_DEVICES``) and
``REPRO_DRYRUN_MESH``: the per-device HLO's cost analysis and collectives
(``collective_bytes``). Both trace the same config, cut the same way:

* ``--width smoke``: the config's smoke variant (2 layers, d_model 256),
  128 tokens by default;
* ``--width full``: the config at its published widths, cut to 2 layers
  (its first two block types, or its first one twice), 512 tokens by
  default;

at ``--batch`` sequences, on a ``--mesh`` of (data, model) devices, in
``--mode`` (``2d``, ``tp_zero1`` or ``fsdp``), for train and prefill
(``--seq`` tokens) and decode (one token against a ``--seq``-slot cache).
The two packages count a whole step in their own ways (the port's
``TraceCounter`` over ATen operators, XLA's cost analysis), so each
ratio is also read against the same ratio on a (1, 1) mesh at the same
config, width, batch and length (``normalised``). Usage::

    PYTHONPATH=src JAX_PLATFORMS=cpu python \\
        tests/torch_collectives_vs_reference.py [--arch llama3.2-1b] \\
        [--mesh 2,2] [--batch 8] [--mode 2d] [--width smoke|full] \\
        [--seq N] [--steps train_4k,prefill_32k,decode_32k]

It prints one markdown table a step (each collective kind's count and
bytes in each package, FLOPs a device) and a summary table: the FLOPs
ratio, the (1, 1) ratio, their quotient, and the summed collective bytes
of each package and their ratio.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys

STEPS = ("train_4k", "prefill_32k", "decode_32k")
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
DEFAULT_SEQ = {"smoke": 128, "full": 512}

#: the depth cut, the same source in both packages' processes
CUT = r"""
def cut(cfg, width, smoke_variant):
    if width == "smoke":
        return smoke_variant(cfg)
    types = []
    for pattern, _count in cfg.layer_groups:
        for t in pattern:
            if t not in types:
                types.append(t)
    pattern = tuple(types[:2]) if len(types) >= 2 \
        else (cfg.layer_groups[0][0][0],) * 2
    return dataclasses.replace(cfg, n_layers=len(pattern),
                               layer_groups=((pattern, 1),))
"""
exec(CUT)

REFERENCE = r"""
import dataclasses, json, sys
from repro.configs import INPUT_SHAPES, get_config, smoke_variant
from repro.launch import dryrun
""" + CUT + r"""
arch, width, mode, shapes, overrides = sys.argv[1], sys.argv[2], \
    sys.argv[3], json.loads(sys.argv[4]), json.loads(sys.argv[5])
dryrun.get_config = lambda name, **kw: dataclasses.replace(
    cut(get_config(name), width, smoke_variant), **overrides, **kw)
out = {}
for name, (seq, batch) in shapes.items():
    dryrun.INPUT_SHAPES[name] = dataclasses.replace(
        INPUT_SHAPES[name], seq_len=seq, global_batch=batch)
    rec = dryrun.run_dryrun(arch, name, mode=mode, verbose=False)
    roof = rec["roofline"]
    out[name] = {"collectives": roof["collectives"],
                 "flops": roof["per_device"]["flops"]}
print("REF" + json.dumps(out))
"""


SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")


def _mesh_env(mesh) -> dict:
    n = 1
    for m in mesh:
        n *= m
    path = os.pathsep.join(p for p in (SRC, os.environ.get("PYTHONPATH"))
                           if p)
    return dict(os.environ, REPRO_DRYRUN_DEVICES=str(n),
                REPRO_DRYRUN_MESH=",".join(map(str, mesh)),
                JAX_PLATFORMS="cpu", PYTHONPATH=path)


def start_reference(arch: str, width: str, mesh, mode: str, batch: int,
                    seq: int, steps=STEPS,
                    overrides=None) -> subprocess.Popen:
    """The reference's dry runs of ``steps`` in a subprocess, started
    (``overrides``: config fields set in both packages);
    :func:`finish_reference` reads them."""
    shapes = {name: (seq, batch) for name in steps}
    return subprocess.Popen(
        [sys.executable, "-c", REFERENCE, arch, width, mode,
         json.dumps(shapes), json.dumps(overrides or {})],
        env=_mesh_env(mesh), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def finish_reference(proc: subprocess.Popen) -> dict:
    """``{step: {"collectives", "flops"}}`` of a started reference run."""
    out, err = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"reference dry run failed:\n{err[-4000:]}")
    line = [ln for ln in out.splitlines() if ln.startswith("REF")]
    return json.loads(line[-1][3:])


def reference(arch: str, width: str, mesh, mode: str, batch: int, seq: int,
              steps=STEPS, overrides=None) -> dict:
    return finish_reference(start_reference(arch, width, mesh, mode, batch,
                                            seq, steps, overrides))


def port_config(arch: str, width: str, mode: str, overrides=None):
    from repro_torch.configs import get_config, smoke_variant
    return dataclasses.replace(cut(get_config(arch), width, smoke_variant),
                               sharding_mode=mode, **(overrides or {}))


def port_record(arch: str, width: str, mesh, mode: str, batch: int,
                seq: int, step: str, record_ops: bool = False,
                overrides=None) -> dict:
    """The port's dry-run record of ``step``, the config and input shape
    as the reference's (its ``attn_kv_block`` too)."""
    from repro_torch.configs import INPUT_SHAPES
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_abstract_mesh
    cfg = port_config(arch, width, mode, overrides)
    shape = dataclasses.replace(INPUT_SHAPES[step], seq_len=seq,
                                global_batch=batch)
    kvb = min(4096, max(1024, seq // 8))
    return dryrun.dryrun_record(
        dataclasses.replace(cfg, attn_kv_block=kvb), shape,
        make_abstract_mesh(tuple(mesh), ("data", "model")),
        record_ops=record_ops)


def port(arch: str, width: str, mesh, mode: str, batch: int, seq: int,
         steps=STEPS, overrides=None) -> dict:
    out = {}
    for name in steps:
        roof = port_record(arch, width, mesh, mode, batch, seq, name,
                           overrides=overrides)["roofline"]
        out[name] = {"collectives": roof["collectives"],
                     "flops": roof["per_device"]["flops"]}
    return out


def collective_bytes(rec: dict) -> float:
    """A record's collective bytes a device, summed over kinds."""
    return float(sum(rec["collectives"]["by_kind"].get(k, 0)
                     for k in KINDS))


def summary_rows(got: dict, ref: dict, got1: dict, ref1: dict) -> list:
    """One row a step: the FLOPs ratio, the (1, 1) ratio, their quotient
    (the normalised ratio), and the collective bytes."""
    rows = []
    for name in got:
        raw = got[name]["flops"] / ref[name]["flops"]
        one = got1[name]["flops"] / ref1[name]["flops"]
        pb, rb = collective_bytes(got[name]), collective_bytes(ref[name])
        rows.append({"step": name, "port_flops": got[name]["flops"],
                     "ref_flops": ref[name]["flops"], "ratio": raw,
                     "ratio_1x1": one, "normalised": raw / one,
                     "port_bytes": pb, "ref_bytes": rb,
                     "bytes_ratio": pb / rb if rb else float("nan")})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--mesh", default="2,2",
                    help="data,model devices (default 2,2)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--mode", default="2d",
                    choices=["2d", "tp_zero1", "fsdp"])
    ap.add_argument("--width", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--seq", type=int, default=None,
                    help="tokens (default 128 smoke, 512 full)")
    ap.add_argument("--steps", default=",".join(STEPS))
    args = ap.parse_args(argv)
    mesh = tuple(int(m) for m in args.mesh.split(","))
    seq = args.seq or DEFAULT_SEQ[args.width]
    steps = tuple(args.steps.split(","))
    key = (args.arch, args.width)
    procs = [start_reference(*key, mesh, args.mode, args.batch, seq, steps),
             start_reference(*key, (1, 1), args.mode, args.batch, seq,
                             steps)]
    got = port(*key, mesh, args.mode, args.batch, seq, steps)
    got1 = port(*key, (1, 1), args.mode, args.batch, seq, steps)
    ref, ref1 = (finish_reference(p) for p in procs)
    print(f"{args.arch} {args.width} (seq {seq}), mesh {mesh}, batch "
          f"{args.batch}, {args.mode}\n")
    print("| step | kind | port count | port bytes | reference count | "
          "reference bytes |")
    print("|---|---|---|---|---|---|")
    for name in steps:
        for kind in KINDS:
            p, r = got[name]["collectives"], ref[name]["collectives"]
            print(f"| {name} | {kind} | {p['counts'][kind]} | "
                  f"{p['by_kind'][kind]} | {r['counts'][kind]} | "
                  f"{r['by_kind'][kind]} |")
        print(f"| {name} | FLOPs a device | {got[name]['flops']:.6g} | | "
              f"{ref[name]['flops']:.6g} | |")
    print("\n| step | port FLOPs | reference FLOPs | ratio | (1, 1) ratio | "
          "normalised | port coll. bytes | reference coll. bytes | "
          "bytes ratio |")
    print("|---|---|---|---|---|---|---|---|---|")
    for r in summary_rows(got, ref, got1, ref1):
        print(f"| {r['step']} | {r['port_flops']:.6g} | "
              f"{r['ref_flops']:.6g} | {r['ratio']:.3f} | "
              f"{r['ratio_1x1']:.3f} | {r['normalised']:.3f} | "
              f"{r['port_bytes']:.6g} | {r['ref_bytes']:.6g} | "
              f"{r['bytes_ratio']:.2f} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
