"""The paper's core claim at example scale, on PyTorch: the DataStates
engine blocks training far less than the DeepSpeed-default /
TorchSnapshot-style baselines for the same checkpoint workload.

The port's counterpart of ``examples/engine_comparison.py``. Runs the same
training loop once per engine (sync, snapshot, datastates-old,
datastates), checkpointing every iteration, and prints a Table-III-style
comparison of blocking time, capture stall, and end-to-end wall time. A
storage-throughput throttle models a parallel filesystem so the
I/O-bound effects are visible at example scale.

    PYTHONPATH=src python examples/torch/engine_comparison.py \\
        [--device cpu] [--steps 8]
"""

import argparse
import dataclasses
import tempfile
import time

from repro_torch.configs import get_config, uniform_groups
from repro_torch.core import CheckpointManager, CheckpointPolicy, EnginePolicy
from repro_torch.training.loop import Trainer


def small_model():
    base = get_config("llama3.2-1b")
    return dataclasses.replace(
        base, name="llama-20m", n_layers=4, d_model=384, n_heads=6,
        n_kv_heads=2, d_ff=1024, vocab=8_192,
        layer_groups=uniform_groups("full", 4))


def run_engine(mode: str, steps: int = 8, device="cuda",
               workdir=None) -> dict:
    """Train ``steps`` steps of :func:`small_model` under engine ``mode``,
    checkpointing every step; fails unless every step was committed."""
    cfg = small_model()
    with tempfile.TemporaryDirectory(dir=workdir) as d:
        # throttle flushes to ~300 MB/s to emulate a contended PFS share;
        # only the EnginePolicy differs between variants
        mgr = CheckpointManager.from_policy(
            d, CheckpointPolicy(engine=EnginePolicy(
                mode=mode, host_cache_bytes=1 << 30, throttle_mbps=300.0)),
            device=device)
        tr = Trainer(cfg, batch=4, seq_len=128, manager=mgr, device=device)
        t0 = time.perf_counter()
        recs = tr.run(steps, ckpt_interval=1)
        mgr.wait_for_persist()
        wall = time.perf_counter() - t0
        futs = mgr._inflight
        blocking = sum(f.stats.blocking_s for f in futs)
        stall = sum(r.ckpt_stall_s for r in recs)
        ckpt_bytes = sum(f.stats.bytes_tensors + f.stats.bytes_objects
                         for f in futs)
        committed = mgr.repository.steps()
        mgr.close()
    if committed != list(range(1, steps + 1)):
        raise AssertionError(f"{mode}: committed steps {committed}, "
                             f"want 1..{steps}")
    return {"wall_s": wall, "blocking_s": blocking, "stall_s": stall,
            "ckpt_gb": ckpt_bytes / 1e9, "steps": steps}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--workdir", default=None,
                    help="directory the temporary checkpoint directories "
                         "are made in (default: the system's)")
    args = ap.parse_args(argv)
    print(f"{'engine':<16}{'wall(s)':>9}{'block(s)':>10}{'stall(s)':>10}"
          f"{'eff.tput(GB/s)':>16}")
    rows = {}
    for mode in ("sync", "snapshot", "datastates-old", "datastates"):
        r = run_engine(mode, args.steps, args.device, args.workdir)
        rows[mode] = r
        blocked = r["blocking_s"] + r["stall_s"]
        tput = r["ckpt_gb"] / max(blocked, 1e-9)
        print(f"{mode:<16}{r['wall_s']:>9.2f}{r['blocking_s']:>10.3f}"
              f"{r['stall_s']:>10.3f}{tput:>16.2f}")
    speedup = rows["sync"]["wall_s"] / rows["datastates"]["wall_s"]
    print(f"\nDataStates end-to-end speedup vs DeepSpeed-default: "
          f"{speedup:.2f}x (paper reports 1.3–2.2x at cluster scale)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
