"""Host times of the sync engine's pickling: C's ``pickle`` against the
port's bridge (``repro_torch.core.pickle_compat``) on a sync-engine graph
of eight fp32 leaves of 64 MiB and one bfloat16 leaf of 2 MiB.

    PYTHONPATH=src python scripts/pickle_bridge_times.py

Prints the best of three of each, in seconds, on this host's CPU.
"""

import pickle
import time

import numpy as np

from repro_torch.core import dtypes, pickle_compat


def best(fn, *args) -> float:
    out = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        fn(*args)
        out = min(out, time.perf_counter() - t0)
    return out


def main() -> None:
    rng = np.random.default_rng(0)
    n = 1 << 24
    graph = {f"state/t{i}@[0:{n}]": {"data": rng.standard_normal(
        n, dtype=np.float32), "dtype": "float32"} for i in range(8)}
    graph["state/b@[0:1048576]"] = {"data": rng.integers(
        0, 1 << 16, 1 << 20, dtype=np.uint16).view(dtypes.BF16_HOST),
        "dtype": "bfloat16"}
    graph["__objects__"] = {"state/meta/step": 3}
    blob = pickle_compat.dumps(graph)
    print(f"{len(blob)} bytes")
    print(f"dump: C pickle.dumps {best(pickle.dumps, graph, 5):.3f} s, "
          f"pickle_compat.dumps {best(pickle_compat.dumps, graph):.3f} s")
    print(f"load: C pickle.loads {best(pickle.loads, blob):.3f} s, "
          f"pickle_compat.loads {best(pickle_compat.loads, blob):.3f} s")


if __name__ == "__main__":
    main()
