"""Differential checkpointing on the main engine path (paper §VII), on
PyTorch.

The port's counterpart of ``examples/differential_checkpointing.py``:
``CheckpointPolicy(delta=DeltaPolicy(keyframe_every=K))`` streams XOR
deltas (the ``xor_checksum_u32`` kernel on ``--device``) of each tensor
against a retained previous snapshot through the async data-movement
engine, compresses them on the flush lanes, and commits them to the
chain-aware catalog; restore replays keyframe ⊕ deltas (the ``delta_xor``
kernel) through the parallel RestoreEngine — bit-exactly.

    PYTHONPATH=src python examples/torch/differential_checkpointing.py \\
        [--device cpu]
"""

import argparse
import tempfile

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_variant
from repro_torch.core import CheckpointManager, CheckpointPolicy, DeltaPolicy
from repro_torch.core.tree import flatten_with_path
from repro_torch.storage.repository import RetentionPolicy
from repro_torch.training.loop import Trainer


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--workdir", default=None,
                    help="directory the temporary checkpoint directory "
                         "is made in (default: the system's)")
    return ap.parse_args(argv)


def _bytes(t) -> np.ndarray:
    return t.detach().cpu().contiguous().view(-1).view(torch.uint8).numpy()


def main(argv=None) -> int:
    args = parse_args(argv)
    cfg = smoke_variant(get_config("llama3.2-1b"))

    with tempfile.TemporaryDirectory(dir=args.workdir) as d:
        mgr = CheckpointManager.from_policy(
            d, CheckpointPolicy(delta=DeltaPolicy(keyframe_every=4)),
            device=args.device)
        tr = Trainer(cfg, batch=2, seq_len=64, manager=mgr,
                     device=args.device)
        for step in range(1, 7):
            tr.run(1)
            mgr.save(tr.step, tr.state(), blocking=True)
            m = mgr.repository.manifest(tr.step)
            meta = m.meta["delta"]
            kind = "keyframe" if meta["keyframe"] else \
                f"delta→{meta['base_step']}"
            print(f"  step {tr.step}: {kind:10s} "
                  f"{m.total_bytes/1e6:7.3f} MB on disk "
                  f"(chain depth {meta['chain_depth']})")

        # restore the last step (a delta) and verify bit-exactness: the
        # manager walks the chain, re-verifies every member's checksums,
        # restores the keyframe, and folds the deltas in
        restored = mgr.restore(tr.state(), step=tr.step)
        for (pa, a), (_pb, b) in zip(
                flatten_with_path(tr.params)[0],
                flatten_with_path(restored["model"])[0]):
            np.testing.assert_array_equal(_bytes(a), _bytes(b))
        print("differential chain restore is bit-exact ✓")

        steps = mgr.repository.steps()
        key_mb = np.mean([mgr.repository.manifest(s).total_bytes
                          for s in steps
                          if mgr.repository.manifest(s)
                          .meta["delta"]["keyframe"]]) / 1e6
        del_mb = np.mean([mgr.repository.manifest(s).total_bytes
                          for s in steps
                          if not mgr.repository.manifest(s)
                          .meta["delta"]["keyframe"]]) / 1e6
        print(f"mean keyframe {key_mb:.3f} MB vs mean delta {del_mb:.3f} MB "
              f"→ {key_mb/max(del_mb, 1e-9):.1f}x smaller increments")

        # chain-aware retention: keep-last-1 still keeps the keyframe the
        # newest delta depends on
        chain = [tr.step]
        while not mgr.repository.manifest(chain[0]).meta["delta"]["keyframe"]:
            chain.insert(0, mgr.repository.manifest(chain[0])
                         .meta["delta"]["base_step"])
        mgr.repository.gc(retention=RetentionPolicy(keep_last_n=1))
        kept = mgr.repository.local_steps()
        print(f"after keep-last-1 GC the chain survives: {kept}")
        assert kept == chain, (kept, chain)
        mgr.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
