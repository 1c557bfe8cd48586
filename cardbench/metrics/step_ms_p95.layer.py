"""Trainer (``training/loop.py``): the 95th percentile of the window's
step times (``IterationRecord.iter_s``), in ms, in the cells whose step
the host's launches hold: there it swings between runs of the same code
more than an end-to-end bound allows (the steps a save slows sit about
it in the cells with saves)."""

import numpy as np


def read(run):
    if not run.records:
        return None
    return 1000.0 * float(np.percentile([r.iter_s for r in run.records], 95))
