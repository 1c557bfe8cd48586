"""Times collectives on CUDA tensors among ranks that share one card
over a gloo group, moved five ways:

- ``gloo_release``: gloo's own CUDA path (its pinned staging from
  PyTorch's host allocator), the allocator's cache emptied after each
  large collective, as the port's ranks moved them before
  :mod:`repro_torch.sharding.gloo_cuda` staged them on the card;
- ``gloo_cached``: the same, the cache kept;
- ``pageable``: the tensor copied into ordinary host memory, gloo's
  CPU collective, the result copied back;
- ``pinned_reuse``: the same through pinned buffers allocated once
  before the timing;
- ``shared_staging``: the functional collective as
  :mod:`repro_torch.sharding.gloo_cuda` routes it, through staging
  buffers on the card that the ranks share by CUDA IPC handle.

    PYTHONPATH=src python scripts/torch/gloo_staging.py [--ranks 4] \\
        [--mib 8,64,256] [--reps 5] [--out PATH]

Each rank's all-gather input and all-reduce tensor is ``--mib`` MiB of
bf16; the all-gather runs over all ranks and over pairs (a (2, 2) mesh's
``data`` axis). Prints one JSON object: the median seconds by
collective, group, size and way, and the card's name and power limit.
Needs a card.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
WAYS = ("gloo_release", "gloo_cached", "pageable", "pinned_reuse",
        "shared_staging")


def _collective(kind: str, out, inp, group) -> None:
    import torch.distributed as dist
    if kind == "all_gather":
        dist.all_gather_into_tensor(out, inp, group=group)
    else:
        out.copy_(inp)
        dist.all_reduce(out, group=group)


def _timed(kind: str, way: str, inp, n: int, group, reps: int,
           staging: dict) -> float:
    import torch
    import torch.distributed as dist
    rows = inp.shape[0] * (n if kind == "all_gather" else 1)
    out = inp.new_empty((rows,) + tuple(inp.shape[1:]))
    times = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        if way == "shared_staging":
            f = torch.ops._c10d_functional
            name = (group or dist.group.WORLD).group_name
            f.wait_tensor(f.all_gather_into_tensor(inp, n, name)
                          if kind == "all_gather" else
                          f.all_reduce(inp, "sum", name))
            torch.cuda.synchronize()
        elif way in ("gloo_release", "gloo_cached"):
            _collective(kind, out, inp, group)
            torch.cuda.synchronize()
            if way == "gloo_release":
                torch._C._host_emptyCache()
        else:
            if way == "pageable":
                hi = inp.cpu()
                ho = torch.empty(out.shape, dtype=out.dtype)
            else:
                hi = staging["in"][:inp.numel()].view(inp.shape)
                ho = staging["out"][:out.numel()].view(out.shape)
                hi.copy_(inp)
            _collective(kind, ho, hi, group)
            out.copy_(ho)
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times[1:])


def _rank(rank: int, n: int, port: int, mib: list, reps: int,
          path: str) -> None:
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=n, rank=rank)
    from repro_torch.sharding import gloo_cuda
    gloo_cuda.install()
    groups = {"all": None}
    if n % 2 == 0:
        pairs = [dist.new_group([i, i + n // 2]) for i in range(n // 2)]
        groups["pairs"] = pairs[rank % (n // 2)]
    most = max(mib) << 20
    staging = {"in": torch.empty(most // 2, dtype=torch.bfloat16,
                                 pin_memory=True),
               "out": torch.empty(n * most // 2, dtype=torch.bfloat16,
                                  pin_memory=True)}
    out = {}
    for size in mib:
        inp = torch.randn(size << 19, device="cuda").to(torch.bfloat16)
        for kind in ("all_gather", "all_reduce"):
            for gname, group in groups.items():
                if kind == "all_reduce" and gname != "all":
                    continue
                gn = n if group is None else dist.get_world_size(group)
                for way in WAYS:
                    out[f"{kind} {gname} {size} MiB {way}"] = _timed(
                        kind, way, inp, gn, group, reps, staging)
    if rank == 0:
        with open(path, "w") as f:
            json.dump(out, f)
    gloo_cuda.release()
    dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--mib", default="8,64,256")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "gloo_staging.json"))
    a = ap.parse_args()
    import torch
    import torch.multiprocessing as mp
    from repro_torch.launch.spmd import free_port
    if not torch.cuda.is_available():
        sys.exit("gloo_staging.py needs a card")
    os.makedirs(os.path.dirname(a.out), exist_ok=True)
    mib = [int(x) for x in a.mib.split(",")]
    mp.spawn(_rank, args=(a.ranks, free_port(), mib, a.reps, a.out),
             nprocs=a.ranks)
    with open(a.out) as f:
        res = json.load(f)
    res["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
