"""Kernels (``kernels/flash_attention.py``, ``csrc/flash_attention.cu``):
the least time of the window's calls of the attention kernel (each
call's FLOP, ``cardbench.flops.attn_flop``, over the bf16 peak) over the
kernel's device time in the trace, in %. Every attention layer of the
configuration takes the kernel at the cell's length, the same
arithmetic a call."""

from cardbench import flops
from cardbench.window import kernel_seconds

KERNEL = "flash_fwd_bf16"


def read(run):
    if not run.summary:
        return None
    n, s = kernel_seconds(run.summary["kernels"], KERNEL)
    if not n or s <= 0:
        return None
    cfg, tr = run.cfg, run.traffic
    H = cfg["n_heads"]
    hd = cfg.get("head_dim") or cfg["d_model"] // H
    calls = [flops.attn_flop(tr["batch"], tr["seq_len"], H, hd,
                             "window" if b == "window" else "full",
                             cfg.get("window", 0))
             for pattern, count in cfg["layer_groups"]
             for b in pattern * count]
    per_call = sum(calls) / len(calls)
    least = n * per_call / flops.peaks(run.kind)["bf16_flop_per_s"]
    return 100.0 * least / s
