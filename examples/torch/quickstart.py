"""Quickstart on PyTorch: lazy asynchronous checkpointing in five minutes.

The port's counterpart of ``examples/quickstart.py``. Trains a reduced
llama3.2-1b on synthetic data with the DataStates engine checkpointing
every second iteration, then restores into a fresh trainer and shows the
two runs continue identically.

The manager is configured the policy-first way (``CheckpointPolicy`` +
``CheckpointManager.from_policy``) plus a ``StateProviderRegistry``
making the per-domain provider routing explicit — the paper's composable
state providers as the public API. The checkpoint kernels and the model
run on ``--device`` (the card by default; ``cpu`` runs the kernels'
plain versions).

    PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]
"""

import argparse
import tempfile

import numpy as np

from repro_torch.configs import get_config, smoke_variant
from repro_torch.core import (CheckpointManager, CheckpointPolicy,
                              EnginePolicy, StateProviderRegistry)
from repro_torch.core.tree import leaves
from repro_torch.training.loop import Trainer


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--workdir", default=None,
                    help="directory the temporary checkpoint directory "
                         "is made in (default: the system's)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    cfg = smoke_variant(get_config("llama3.2-1b"))
    print(f"arch={cfg.name}  layers={cfg.n_layers}  d_model={cfg.d_model}")

    # Policy: engine tuning + per-domain provider routing. The registry's
    # rules match in order; here model tensors are pinned raw and the rest
    # takes the adaptive default ("auto": raw, or XOR-delta under a
    # DeltaPolicy).
    policy = CheckpointPolicy(
        engine=EnginePolicy(mode="datastates", host_cache_bytes=256 << 20),
        providers=(StateProviderRegistry()
                   .add_rule(provider="tensor", domain="model")
                   .add_rule(provider="auto")))

    with tempfile.TemporaryDirectory(dir=args.workdir) as ckpt_dir:
        # --- train 6 steps, lazy-checkpoint every 2 -----------------------
        mgr = CheckpointManager.from_policy(ckpt_dir, policy,
                                            device=args.device)
        trainer = Trainer(cfg, batch=4, seq_len=64, manager=mgr,
                          device=args.device)
        records = trainer.run(6, ckpt_interval=2)
        for r in records:
            flag = " [ckpt]" if r.ckpt_requested else ""
            print(f"  step {r.step}: loss={r.loss:.4f} "
                  f"iter={r.iter_s*1e3:.0f}ms "
                  f"stall={r.ckpt_stall_s*1e6:.0f}us{flag}")
        mgr.wait_for_commit()
        man = mgr.repository.manifest(mgr.latest_step())
        print("domain routing on disk:",
              {d: v["providers"] for d, v in man.meta["domains"].items()})

        # --- resume from the latest checkpoint ----------------------------
        resumed = Trainer(cfg, batch=4, seq_len=64, manager=mgr,
                          device=args.device)
        step = resumed.resume()
        print(f"resumed at step {step}")
        cont_a = trainer.run(2)[-2:]
        cont_b = resumed.run(2)[-2:]
        # the resumed run replays the same trajectory
        la = [r.loss for r in cont_a]
        lb = [r.loss for r in cont_b]
        print(f"  original  continues: {la}")
        print(f"  restored  continues: {lb}")
        np.testing.assert_allclose(la, lb, rtol=1e-6)

        # --- selective restore: model domain only -------------------------
        serving = Trainer(cfg, batch=4, seq_len=64, manager=mgr,
                          device=args.device)
        serving.resume(domains=("model",))
        read = mgr.last_restore_stats.bytes_read
        model_bytes = sum(t.numel() * t.element_size()
                          for t in leaves(serving.params))
        print(f"model-only resume read {read/2**20:.1f} MiB "
              f"(optimizer bytes never touched)")
        assert read == model_bytes, (read, model_bytes)
        print("restored trainer reproduces the original trajectory ✓")
        mgr.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
