"""Flush and repository (``core/engine.py`` lanes, ``storage/``): the
mean time from a save's request to its files persisted,
``CheckpointStats.persist_latency_s``, in s."""


def read(run):
    fs = run.futures
    return sum(f.stats.persist_latency_s for f in fs) / len(fs) \
        if fs else None
