"""Training launcher (port of ``repro/launch/train.py``).

Runs a (reduced or full) config with the two-phase lazy-checkpoint loop
on ``--device`` (``cuda`` by default; ``cpu`` only when asked for, as the
tests do). The flags are the JAX launcher's; ``--engine`` picks any of the
four engines the paper compares (``sync``, ``snapshot``,
``datastates-old``, ``datastates``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --smoke --steps 20 --ckpt-interval 5 --ckpt-dir /tmp/ckpt

``--arch`` takes any config of ``repro_torch.configs.list_configs()``,
the JAX package's eleven: llama3.2-1b, llama2-7b, starcoder2-7b,
gemma3-27b, command-r-35b, musicgen-medium, dbrx-132b,
llama4-maverick-400b-a17b, recurrentgemma-2b, rwkv6-7b and paligemma-3b
(``--smoke`` for a size a CPU runs).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family variant (CPU-sized)")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--ckpt-interval", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--engine", default="datastates",
                    choices=["datastates", "datastates-old", "snapshot",
                             "sync"])
    ap.add_argument("--host-cache-mb", type=int, default=512)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--json", default=None, help="write iteration records")
    ap.add_argument("--device", default="cuda",
                    help="where the model and the checkpoint kernels run")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.core import (CheckpointManager, CheckpointPolicy,
                                  EnginePolicy)
    from repro_torch.training.loop import Trainer

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)

    manager = None
    if args.ckpt_interval:
        manager = CheckpointManager.from_policy(
            args.ckpt_dir, CheckpointPolicy(engine=EnginePolicy(
                mode=args.engine,
                host_cache_bytes=args.host_cache_mb << 20)),
            device=args.device)
    try:
        trainer = Trainer(cfg, batch=args.batch, seq_len=args.seq_len,
                          manager=manager, device=args.device)
        if args.resume and manager is not None \
                and manager.latest_step() is not None:
            step = trainer.resume()
            print(f"resumed from step {step}")

        t0 = time.perf_counter()
        records = trainer.run(args.steps, ckpt_interval=args.ckpt_interval)
        wall = time.perf_counter() - t0
    finally:
        if manager is not None:
            manager.close()
    losses = [r.loss for r in records]
    stalls = [r.ckpt_stall_s for r in records]
    print(f"arch={cfg.name} device={trainer.device} steps={len(records)} "
          f"wall={wall:.2f}s final_loss={losses[-1]:.4f} "
          f"ckpt_stall_total={sum(stalls)*1e3:.1f}ms")
    if not all(math.isfinite(l) for l in losses):
        raise RuntimeError(f"non-finite loss: {losses}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump([r.__dict__ for r in records], f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
