"""Inline lock-hierarchy declarations (the source of truth the runtime
witness consumes).

Every lock that participates in the committer / cascade / rank lanes is
declared *next to the code it governs* with :func:`declares_lock` (class
attributes) or :func:`named_lock` (locals/closures). A declaration names
the lock and assigns it a **rank**: a thread may only acquire a lock whose
rank is *strictly greater* than every lock it already holds, so the
acquisition order over the whole system is a DAG by construction.

The declared hierarchy, outermost (lowest rank) to innermost (the JAX
package's ranks):

======  =====================  ==========================================
rank    lock                   owner
======  =====================  ==========================================
10      coordinator.job        ``dist.coordinator._SaveJob.lock``
12      coordinator.dead       ``dist.coordinator.Coordinator._dead_lock``
15      coordinator.node       ``dist.coordinator._NodeCommit.lock``
16      ipc.proc               ``dist.process_runtime.ProcessRankRuntime._lock``
20      barrier.cond           ``dist.barrier.CollectiveBarrier._cond``
30      manager.delta_tracker  ``core.checkpoint._DeltaChainTracker._lock``
40      repository.state       ``storage.repository.CheckpointRepository._lock``
42      fleet.fabric           ``fleet.fabric.FleetFabric._lock``
44      fleet.cache            ``fleet.cache.FleetCache._lock``
46      fleet.exchange         ``fleet.peer.PeerExchange._lock``
48      fleet.session          ``fleet.peer._SwapSession._cond``
50      engine.save_progress   per-save closure lock in ``DataMovementEngine.submit``
52      engine.file_state      ``core.engine._FileState.lock``
54      snapshot.cache         ``core.state_provider.SnapshotCache._lock``
56      encode.budget          ``core.state_provider.EncodeBudget._cond``
58      provider.stage         ``core.state_provider.TensorStateProvider._cond``
60      writer.append          ``core.layout.FileWriter._append_lock``
70      host_cache.alloc       ``core.host_cache.HostCache._lock`` / ``._freed``
80      obs.trace_registry     ``obs.trace.Tracer._lock``
82      obs.metrics            ``obs.metrics.MetricsRegistry._lock``
======  =====================  ==========================================

This module is stdlib-only and imported by the concurrency-bearing runtime
modules; it must never import anything heavy (numpy/torch) or anything from
``repro_torch`` outside :mod:`repro_torch.analysis`.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
from typing import Any, Callable, Dict, Optional, Tuple

__all__ = ["LockDecl", "LOCK_REGISTRY", "declared_hierarchy",
           "declares_lock", "named_lock", "named_condition"]


@dataclasses.dataclass(frozen=True)
class LockDecl:
    """One declared lock: its global name, rank, and where it lives."""

    name: str
    rank: int
    attrs: Tuple[str, ...]   # instance attributes materializing this lock
    owner: str               # "module.QualName" of the declaring class


#: "module.QualName" -> LockDecl for every class-level declaration, plus
#: "<name>" entries for named_lock/named_condition call sites.
LOCK_REGISTRY: Dict[str, LockDecl] = {}


def declared_hierarchy() -> Dict[str, int]:
    """Lock name -> rank for every declaration registered at import time."""
    out: Dict[str, int] = {}
    for decl in LOCK_REGISTRY.values():
        prev = out.setdefault(decl.name, decl.rank)
        if prev != decl.rank:
            raise ValueError(
                f"lock {decl.name!r} declared with conflicting ranks "
                f"{prev} and {decl.rank}")
    return out


def _register(decl: LockDecl) -> None:
    existing = LOCK_REGISTRY.get(decl.owner)
    if existing is not None and existing != decl:
        raise ValueError(
            f"{decl.owner}: conflicting lock declarations "
            f"{existing} vs {decl}")
    LOCK_REGISTRY[decl.owner] = decl
    # surface rank conflicts at declaration time, not first use
    declared_hierarchy()


def _maybe_wrap(name: str, rank: int, obj: Any) -> Any:
    """Instrument ``obj`` when a witness is recording (no-op otherwise)."""
    from . import witness  # deferred: avoid cycles at import time
    w = witness.current()
    if w is None or isinstance(obj, witness.WitnessLock):
        return obj
    return witness.WitnessLock(name, rank, obj, w)


def declares_lock(name: str, *, rank: int,
                  attrs: Tuple[str, ...]) -> Callable[[type], type]:
    """Class decorator declaring that instances own the lock ``name``.

    ``attrs`` lists every instance attribute that materializes the lock —
    the ``threading.Lock`` itself plus any ``Condition`` built over it
    (aliases of one lock share its name and rank, so waiting on your own
    condition variable is never a hierarchy violation).

    Zero runtime cost unless a :mod:`repro_torch.analysis.witness` recording is
    active, in which case the declared attributes are replaced with
    recording proxies after ``__init__`` returns.
    """
    attrs = tuple(attrs)

    def deco(cls: type) -> type:
        decl = LockDecl(name=name, rank=rank, attrs=attrs,
                        owner=f"{cls.__module__}.{cls.__qualname__}")
        _register(decl)
        cls.__ckpt_lock_decl__ = decl  # type: ignore[attr-defined]
        orig_init = cls.__init__

        @functools.wraps(orig_init)
        def __init__(self, *a: Any, **k: Any) -> None:
            orig_init(self, *a, **k)
            from . import witness
            if witness.current() is None:
                return
            for attr in attrs:
                obj = getattr(self, attr, None)
                if obj is not None:
                    setattr(self, attr, _maybe_wrap(name, rank, obj))

        cls.__init__ = __init__  # type: ignore[assignment]
        return cls

    return deco


def named_lock(name: str, *, rank: int) -> Any:
    """A declared ``threading.Lock`` for locals/closures a class decorator
    cannot reach (e.g. the per-save aggregation lock in
    ``DataMovementEngine.submit``)."""
    _register(LockDecl(name=name, rank=rank, attrs=(), owner=name))
    return _maybe_wrap(name, rank, threading.Lock())


def named_condition(name: str, *, rank: int,
                    lock: Optional[Any] = None) -> Any:
    """A declared ``threading.Condition`` (over ``lock`` if given)."""
    _register(LockDecl(name=name, rank=rank, attrs=(), owner=name))
    return _maybe_wrap(name, rank, threading.Condition(lock))
