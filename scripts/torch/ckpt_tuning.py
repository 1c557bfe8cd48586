"""Checkpoint-engine tuning sweep on PyTorch: chunk size × flush threads
vs effective blocking throughput, DataStates engine.

The port's counterpart of ``scripts/ckpt_tuning.py``:

    PYTHONPATH=src python scripts/torch/ckpt_tuning.py [--device cpu]

The payload is 256 MiB: half a host (numpy) array, half a tensor on
``--device`` (the card by default). Hypothesis grid: larger chunks
amortize per-chunk dispatch overhead until they defeat pipelining (fewer
in-flight units than threads); more threads help until the (throttled)
storage path saturates. Records to
``experiments/perf/ckpt_tuning_torch.json``.
"""

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.core import CheckpointManager, CheckpointPolicy, EnginePolicy
from repro_torch.core.tree import leaves

PAYLOAD_MB = 256
THROTTLE = 600.0  # MB/s per thread — emulated PFS share
CHUNKS_MB = (1, 4, 16, 64)
THREADS = (1, 2, 4, 8)
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def make_state(mb: int, device="cuda"):
    n = mb * (1 << 20) // 4
    rng = np.random.default_rng(0)
    host = rng.normal(size=(n // 2,)).astype(np.float32)
    dev = torch.from_numpy(rng.normal(size=(n // 2,)).astype(np.float32)
                           ).to(device)
    return {"host": host, "dev": dev,
            "meta": {"step": 1, "cfg": {"lr": 1e-4}}}


def _nbytes(state) -> int:
    total = 0
    for x in leaves(state):
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
        elif hasattr(x, "nbytes"):
            total += x.nbytes
    return total


def run_one(state, chunk_mb: int, threads: int, device="cuda",
            workdir=None) -> dict:
    """One save of ``state`` at ``chunk_mb`` MiB chunks and ``threads``
    flush threads: the blocking prologue, the capture and the persist."""
    policy = CheckpointPolicy(engine=EnginePolicy(
        mode="datastates", host_cache_bytes=1 << 30,
        chunk_bytes=chunk_mb << 20, flush_threads=threads,
        throttle_mbps=THROTTLE))
    with tempfile.TemporaryDirectory(dir=workdir) as d:
        mgr = CheckpointManager.from_policy(d, policy, device=device)
        t0 = time.perf_counter()
        fut = mgr.save(1, state)
        blocking = time.perf_counter() - t0
        t1 = time.perf_counter()
        fut.wait_captured()
        capture = time.perf_counter() - t1
        fut.wait_persisted()
        persist = time.perf_counter() - t0
        mgr.close()
    nbytes = _nbytes(state)
    return {"chunk_mb": chunk_mb, "threads": threads,
            "blocking_s": blocking, "capture_s": capture,
            "persist_s": persist,
            "blocking_tput_gbps": nbytes / max(blocking + capture, 1e-9) / 1e9,
            "persist_tput_gbps": nbytes / max(persist, 1e-9) / 1e9}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    state = make_state(PAYLOAD_MB, args.device)
    rows = []
    print(f"{'chunk':>6}{'thr':>4}{'block(ms)':>11}{'capture(ms)':>12}"
          f"{'persist(s)':>11}{'persist GB/s':>13}")
    for chunk_mb in CHUNKS_MB:
        for threads in THREADS:
            r = run_one(state, chunk_mb, threads, args.device)
            rows.append(r)
            print(f"{chunk_mb:>6}{threads:>4}{r['blocking_s']*1e3:>11.1f}"
                  f"{r['capture_s']*1e3:>12.1f}{r['persist_s']:>11.2f}"
                  f"{r['persist_tput_gbps']:>13.2f}")
    out = os.path.join(ROOT, "experiments", "perf", "ckpt_tuning_torch.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump({"payload_mb": PAYLOAD_MB, "throttle_mbps": THROTTLE,
                   "device": str(state["dev"].device), "rows": rows},
                  f, indent=2)
    print("wrote", out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
