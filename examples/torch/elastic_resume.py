"""Elastic resume on PyTorch: save on one mesh shape, restore onto another.

The port's counterpart of ``examples/elastic_resume.py``. The checkpoint
stores whatever shard boundaries the *training* layout dictated (the
planner never reshards, paper §IV-C). The parallel RestoreEngine makes the
reverse direction cheap: for each target shard of the *new* mesh it
intersects the stored shard regions up front and issues ranged reads for
just the overlapping bytes — so a 4×2 → 2×4 mesh change needs no offline
reshard pass.

The JAX example forces 8 XLA host devices; here the meshes are grids of
virtual devices (``repro_torch.launch.mesh.make_mesh``) on ``--device``,
and the state is laid out on them as ``ShardedTensor``s.

    PYTHONPATH=src python examples/torch/elastic_resume.py [--device cpu]
"""

import argparse
import tempfile

import numpy as np
import torch

from repro_torch.core import CheckpointManager
from repro_torch.launch.mesh import make_mesh
from repro_torch.sharding import shard_tree, unshard


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--workdir", default=None,
                    help="directory the temporary checkpoint directory "
                         "is made in (default: the system's)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    # --- "training" run: a 4×2 data×model mesh --------------------------
    mesh_a = make_mesh((4, 2), ("data", "model"), args.device)
    w = torch.arange(256 * 128, dtype=torch.float32).reshape(256, 128)
    m = torch.ones((256, 128), dtype=torch.float32)
    placed = shard_tree(
        {"model": {"w": w}, "optimizer": {"m": m}},   # ZeRO-1-style m
        {"model": {"w": ("data", "model")},
         "optimizer": {"m": ("data", None)}}, mesh_a)
    state = dict(placed, meta={"step": 12, "mesh": "4x2"})

    with tempfile.TemporaryDirectory(dir=args.workdir) as d:
        mgr = CheckpointManager.from_policy(d, device=args.device)
        mgr.save(12, state, blocking=True)
        print(f"saved on mesh {mesh_a.devices.shape} "
              f"({mesh_a.devices.size} virtual devices on "
              f"{mesh_a.device})")

        # --- "resume" run: the job comes back on a 2×4 mesh -------------
        mesh_b = make_mesh((2, 4), ("data", "model"), args.device)
        template = dict(shard_tree(
            {"model": {"w": torch.zeros(256, 128)},
             "optimizer": {"m": torch.zeros(256, 128)}},
            {"model": {"w": ("model", "data")},
             "optimizer": {"m": (None, "model")}}, mesh_b),
            meta={"step": 0, "mesh": ""})
        restored = mgr.restore(template, step=12)
        stats = mgr.last_restore_stats
        mgr.close()

        np.testing.assert_array_equal(
            unshard(restored["model"]["w"]).cpu().numpy(), w.numpy())
        np.testing.assert_array_equal(
            unshard(restored["optimizer"]["m"]).cpu().numpy(), m.numpy())
        assert restored["meta"]["step"] == 12
        assert restored["model"]["w"].mesh == mesh_b
        shard_shapes = sorted({tuple(s.data.shape)
                               for s in restored["model"]["w"]
                               .addressable_shards})
        print(f"restored onto mesh {mesh_b.devices.shape} with flipped "
              f"partition specs; per-device shard shape {shard_shapes}")
        print(f"restore stats: {stats.bytes_read / 2**20:.2f} MiB in "
              f"{stats.n_ranges} ranged reads across {stats.n_files} files "
              f"({stats.threads} threads; index {stats.index_s * 1e3:.1f} ms, "
              f"read {stats.read_s * 1e3:.1f} ms, assemble "
              f"{stats.assemble_s * 1e3:.1f} ms)")
        print("elastic resume across mesh shapes ✓")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
