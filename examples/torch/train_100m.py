"""End-to-end run on PyTorch: train a ~100M-parameter llama-family
model with per-interval lazy checkpoints, crash after a while, and resume.

The port's counterpart of ``examples/train_100m.py``: a real (not
smoke-reduced) ~100M config, a few hundred steps, checkpoint every N
iterations with the DataStates engine, then a simulated failure + restart
that verifies the resumed trajectory matches.

    PYTHONPATH=src python examples/torch/train_100m.py [--steps 300] \\
        [--fast] [--device cpu]

``--fast`` shrinks steps/sequence for CI-style runs.
"""

import argparse
import dataclasses
import shutil
import time

import numpy as np

from repro_torch.configs import get_config, uniform_groups
from repro_torch.core import CheckpointManager, CheckpointPolicy, EnginePolicy
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.training.loop import Trainer


def make_100m_config():
    """A ~100M dense llama-family model (8L, d=768, 12H/4KV, ff=2048)."""
    base = get_config("llama3.2-1b")
    return dataclasses.replace(
        base, name="llama-100m", n_layers=8, d_model=768, n_heads=12,
        n_kv_heads=4, d_ff=2048, vocab=32_000,
        layer_groups=uniform_groups("full", 8),
    )


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-interval", type=int, default=25)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_torch_100m_ckpt")
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.fast:
        args.seq_len, args.batch, args.ckpt_interval = 64, 2, 3
        args.steps = min(args.steps, 12)
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    cfg = make_100m_config()
    print(f"model: {cfg.name}  params≈{cfg.n_params()/1e6:.1f}M")

    # fresh run: this example demonstrates crash+resume WITHIN one run
    shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    mgr = CheckpointManager.from_policy(
        args.ckpt_dir, CheckpointPolicy(engine=EnginePolicy(
            mode="datastates", host_cache_bytes=2 << 30)),
        device=args.device)
    tr = Trainer(cfg, batch=args.batch, seq_len=args.seq_len, manager=mgr,
                 hp=AdamWConfig(lr=3e-4), device=args.device)

    # ---- phase 1: train until a "failure" two thirds of the way in -------
    crash_at = (2 * args.steps // 3) // args.ckpt_interval * args.ckpt_interval
    if crash_at < args.ckpt_interval:
        raise SystemExit(f"--steps {args.steps} leaves no checkpoint before "
                         f"the crash at two thirds (interval "
                         f"{args.ckpt_interval})")
    t0 = time.perf_counter()
    recs = tr.run(crash_at, ckpt_interval=args.ckpt_interval)
    mgr.wait_for_persist()
    t1 = time.perf_counter()
    stalls = sum(r.ckpt_stall_s for r in recs)
    print(f"phase 1: {crash_at} steps in {t1-t0:.1f}s  "
          f"loss {recs[0].loss:.3f}→{recs[-1].loss:.3f}  "
          f"total ckpt stall {stalls*1e3:.1f}ms "
          f"({100*stalls/(t1-t0):.2f}% of wall)")
    ref_losses = [r.loss
                  for r in tr.run(args.steps - crash_at)[-(args.steps - crash_at):]]
    print(f"(reference continuation to step {args.steps} recorded)")

    # ---- phase 2: "crash" — new process state, resume from latest --------
    tr2 = Trainer(cfg, batch=args.batch, seq_len=args.seq_len, manager=mgr,
                  hp=AdamWConfig(lr=3e-4), device=args.device)
    step = tr2.resume()
    print(f"phase 2: resumed from step {step}")
    recs2 = tr2.run(args.steps - step, ckpt_interval=args.ckpt_interval)
    got_losses = [r.loss for r in recs2]
    np.testing.assert_allclose(got_losses, ref_losses, rtol=1e-5, atol=1e-5)
    print(f"resumed trajectory matches uninterrupted run over "
          f"{len(got_losses)} steps ✓  (final loss {got_losses[-1]:.3f})")
    mgr.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
