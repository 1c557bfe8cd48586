"""Trainer (``training/loop.py``): the window's stall on its saves, the
prologue and the capture barrier (``IterationRecord.ckpt_stall_s``) less
the exit drain (``Trainer.exit_drain_s``), over the saves, in ms. A mean
of three; its spread between runs of the same code is too wide for an
end-to-end bound."""


def read(run):
    n = len(run.futures)
    if not n:
        return None
    total = sum(r.ckpt_stall_s for r in run.records) - run.exit_drain_s
    return 1000.0 * total / n
