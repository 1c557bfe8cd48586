"""Serve a model from a training checkpoint on PyTorch: batched prefill +
decode.

The port's counterpart of ``examples/serve_restore.py``. Trains briefly,
checkpoints, then restores the parameters into a serving engine and runs
greedy generation over a batch of prompts — the suspend/resume +
deployment use-case from the paper's introduction.

    PYTHONPATH=src python examples/torch/serve_restore.py [--device cpu]
"""

import argparse
import tempfile

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_variant
from repro_torch.core import CheckpointManager
from repro_torch.serving.engine import greedy_generate, load_params_for_serving
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
    cfg = smoke_variant(get_config("starcoder2-7b"))
    with tempfile.TemporaryDirectory(dir=args.workdir) as d:
        mgr = CheckpointManager.from_policy(d, device=args.device)
        tr = Trainer(cfg, batch=4, seq_len=64, manager=mgr,
                     device=args.device)
        tr.run(4, ckpt_interval=4)
        mgr.wait_for_persist()
        mgr.close()
        print(f"trained {tr.step} steps, checkpoint persisted")

        # --- restore the *model only* into a serving process --------------
        # load_params_for_serving plans the shard intersections up front and
        # reads just the parameter byte ranges (no optimizer state) through
        # the parallel RestoreEngine, onto the template's device.
        params, rstats = load_params_for_serving(d, tr.params)
        print(f"restored params: {rstats.bytes_read / 2**20:.1f} MiB read "
              f"in {rstats.n_ranges} ranges over {rstats.threads} threads "
              f"(index {rstats.index_s * 1e3:.1f} ms, read "
              f"{rstats.read_s * 1e3:.1f} ms, assemble "
              f"{rstats.assemble_s * 1e3:.1f} ms)")

        rng = np.random.default_rng(0)
        batch = 4
        prompts = torch.as_tensor(
            rng.integers(1, cfg.vocab, size=(batch, 12)), dtype=torch.int32,
            device=tr.device)
        out = greedy_generate(cfg, params, {"tokens": prompts}, n_new=16)
        print(f"served batch of {batch} prompts → completions "
              f"{tuple(out.shape)}:")
        for i in range(batch):
            print(f"  req {i}: prompt={prompts[i].cpu().numpy()[:6]}... "
                  f"completion={out[i].cpu().numpy()[:8]}...")
        assert tuple(out.shape) == (batch, 16)
        print("batched serve-from-checkpoint ✓")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
