"""Engine (``core/engine.py``): the mean time from a save's request to
its state captured on the host, ``CheckpointStats.capture_latency_s``,
in ms."""


def read(run):
    fs = run.futures
    return 1000.0 * sum(f.stats.capture_latency_s for f in fs) / len(fs) \
        if fs else None
