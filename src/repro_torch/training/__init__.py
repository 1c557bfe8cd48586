"""The training driver (port of ``repro/training``)."""
