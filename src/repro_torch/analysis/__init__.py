"""``ckptlint``: the port's static analysis and runtime lock witness.

Static CLI: ``python -m repro_torch.analysis [paths]`` (default
``src/repro_torch``), the port's own copy of the JAX package's rules.
Runtime: :mod:`repro_torch.analysis.locks` declarations +
:mod:`repro_torch.analysis.witness` recordings.
"""

from .linter import Finding, run
from .locks import LOCK_REGISTRY, declared_hierarchy, declares_lock, \
    named_condition, named_lock

__all__ = ["Finding", "run", "LOCK_REGISTRY", "declared_hierarchy",
           "declares_lock", "named_lock", "named_condition"]
