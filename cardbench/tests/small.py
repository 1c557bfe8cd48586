"""A cell of the benchmark cut to a size the CPU runs in seconds: the
same configuration keys, traffic mix, policy and limits, at widths of
64 and 2 x 24 tokens, a small host cache."""

import copy

from cardbench import harness


def small_cell(workload: str) -> dict:
    cell = harness.cell_spec(workload)
    cfg = cell["cfg"]
    small = dict(d_model=64, n_heads=4, d_ff=128,
                 n_kv_heads=4 if cfg["n_kv_heads"] == cfg["n_heads"] else 2,
                 vocab=32 if cfg.get("n_codebooks") else 64)
    if cfg.get("n_memory_embeds"):
        small["n_memory_embeds"] = 4
    if cfg.get("window"):
        small["window"] = 8
    cell["cfg"] = {**cfg, **small}
    tr = copy.deepcopy(cell["traffic_spec"])
    tr["batch"], tr["seq_len"] = 2, 24
    tr["checkpoint"]["engine"]["host_cache_bytes"] = 64 << 20
    cell["traffic_spec"] = tr
    return cell
