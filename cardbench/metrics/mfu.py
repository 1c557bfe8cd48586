"""Model step (``models/``): the model FLOP of the window's steps
(``cardbench.flops.step_flop``, no recomputation) over the window's time
and the card's bf16 peak, in %."""

from cardbench import flops


def read(run):
    if not run.records:
        return None
    tr = run.traffic
    f = flops.step_flop(run.cfg, tr["batch"], tr["seq_len"]) \
        * len(run.records)
    return 100.0 * f / run.window_s / flops.peaks(run.kind)["bf16_flop_per_s"]
