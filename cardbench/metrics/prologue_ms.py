"""Manager (``core/checkpoint.py``): the mean blocking prologue of the
window's saves, ``CheckpointStats.blocking_s``, in ms."""


def read(run):
    fs = run.futures
    return 1000.0 * sum(f.stats.blocking_s for f in fs) / len(fs) \
        if fs else None
