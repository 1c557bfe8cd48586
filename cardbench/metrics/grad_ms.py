"""Trainer (``training/loop.py``): the mean forward and backward time of
the window's steps, ``IterationRecord.grad_s`` (CUDA events on the
step's stream), in ms."""


def read(run):
    g = [r.grad_s for r in run.records]
    return 1000.0 * sum(g) / len(g) if g else None
