"""Lock-hierarchy declarations and the runtime lock witness (the static
linter of the JAX package is not yet ported)."""

from .locks import LOCK_REGISTRY, declared_hierarchy, declares_lock, \
    named_condition, named_lock

__all__ = ["LOCK_REGISTRY", "declared_hierarchy", "declares_lock",
           "named_lock", "named_condition"]
