"""The port's benchmark: ``repro_torch``'s training step under lazy
checkpoints on one H100, one cell a run (``python3 cardbench/run.py
--workload <name> --seed <n> --seconds <s> --trace <0|1>``).

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the name ``BENCHMARK.json`` gives
it: ``configs/<config>.json``, ``traffic/<traffic>.json`` and
``metrics/<metric>.py``. :mod:`cardbench.reference`, :mod:`cardbench.
reader` and :mod:`cardbench.check` are the yardstick: they import
nothing of the program and nothing of JAX.
"""
