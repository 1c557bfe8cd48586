"""Providers (``core/state_provider.py``): the bytes the window's saves
committed (every file under the checkpoint directory) over the bytes of
state they captured (``CheckpointStats.bytes_tensors`` and
``bytes_objects``)."""


def read(run):
    captured = sum(f.stats.total_bytes for f in run.futures)
    return run.written_bytes / captured if captured else None
