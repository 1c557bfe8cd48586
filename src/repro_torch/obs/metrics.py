"""Process-wide metrics registry + the unified per-operation report schema.

The registry holds counters (monotonic totals: bytes staged / encoded /
written per codec, GC reclaim), gauges (host-cache occupancy), and
histograms (reservation wait, barrier wait, commit latency). Everything is
updated under one declared lock — ``obs.metrics`` at rank 82, above every
runtime lock — and ``snapshot()`` returns plain data, so recording is legal
from any instrumented seam and never does I/O.

:class:`SaveReport` / :class:`RestoreReport` put the engine's divergent
stats objects (``CheckpointFuture.stats``, ``RestoreStats``) behind one
dict schema::

    {"kind": "save" | "restore",
     "step": int | None,
     "phases": {phase_name: seconds, ...},
     "bytes": {name: int, ...},
     "counts": {name: int, ...},
     "extra": {...}}

Reports consume this shape instead of reaching into each stats object's
ad-hoc attributes.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, Optional

from repro_torch.analysis.locks import declares_lock

__all__ = ["MetricsRegistry", "SaveReport", "RestoreReport", "cascade_report",
           "metrics"]

_HIST_SAMPLE_CAP = 512  # bounded reservoir per histogram


class _Hist:
    __slots__ = ("count", "total", "vmin", "vmax", "samples")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")
        self.samples: List[float] = []

    def observe(self, v: float) -> None:
        self.count += 1
        self.total += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)
        if len(self.samples) < _HIST_SAMPLE_CAP:
            self.samples.append(v)

    def snapshot(self) -> Dict[str, float]:
        return {"count": self.count, "sum": self.total,
                "min": self.vmin if self.count else 0.0,
                "max": self.vmax if self.count else 0.0,
                "mean": (self.total / self.count) if self.count else 0.0}


@declares_lock("obs.metrics", rank=82, attrs=("_lock",))
class MetricsRegistry:
    """Thread-safe counters / gauges / histograms with dict snapshots."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, _Hist] = {}

    def inc(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = _Hist()
            h.observe(value)

    def get_counter(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0.0)

    def snapshot(self) -> Dict[str, Any]:
        """Plain-data view: {"counters": {...}, "gauges": {...},
        "histograms": {name: {count,sum,min,max,mean}}}."""
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": {k: h.snapshot()
                               for k, h in self._hists.items()},
            }

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()


#: The process-wide registry every instrumented seam records into.
metrics = MetricsRegistry()


def _clean(d: Dict[str, Any]) -> Dict[str, Any]:
    return {k: v for k, v in d.items() if v is not None}


@dataclasses.dataclass
class SaveReport:
    """One save, as the unified report schema (see module docstring)."""

    step: Optional[int]
    phases: Dict[str, float]
    bytes: Dict[str, int]
    counts: Dict[str, int]
    extra: Dict[str, Any]
    kind: str = "save"

    @classmethod
    def from_future(cls, future: Any) -> "SaveReport":
        """Build from a :class:`~repro_torch.core.engine.CheckpointFuture` (or the
        coordinator's aggregate future) — any object with a
        ``CheckpointStats``-shaped ``.stats``."""
        st = future.stats
        phases = {
            "blocking_s": st.blocking_s,
            "stage_s": st.stage_s,
            "serialize_s": st.serialize_s,
            "flush_s": st.flush_s,
        }
        if st.t_captured:
            phases["capture_s"] = st.capture_latency_s
        if st.t_persisted:
            phases["persist_s"] = st.persist_latency_s
        commit_s = getattr(st, "commit_s", 0.0)
        if commit_s:
            phases["commit_s"] = commit_s
        return cls(
            step=getattr(future, "step", None),
            phases=phases,
            bytes={"tensors": st.bytes_tensors, "objects": st.bytes_objects,
                   "total": st.total_bytes},
            counts={"files": st.n_files, "tensors": st.n_tensors},
            extra=dict(st.extra),
        )

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "step": self.step,
                "phases": _clean(self.phases), "bytes": dict(self.bytes),
                "counts": dict(self.counts), "extra": dict(self.extra)}


@dataclasses.dataclass
class RestoreReport:
    """One restore, as the unified report schema."""

    step: Optional[int]
    phases: Dict[str, float]
    bytes: Dict[str, int]
    counts: Dict[str, int]
    extra: Dict[str, Any]
    kind: str = "restore"

    @classmethod
    def from_stats(cls, stats: Any,
                   step: Optional[int] = None) -> "RestoreReport":
        """Build from a :class:`~repro_torch.core.restore.RestoreStats`."""
        return cls(
            step=step,
            phases={"index_s": stats.index_s, "plan_s": stats.plan_s,
                    "verify_s": stats.verify_s, "read_s": stats.read_s,
                    "fold_s": stats.fold_s, "assemble_s": stats.assemble_s},
            bytes={"read": stats.bytes_read},
            counts={"tensors": getattr(stats, "n_tensors", 0)},
            extra={},
        )

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "step": self.step,
                "phases": _clean(self.phases), "bytes": dict(self.bytes),
                "counts": dict(self.counts), "extra": dict(self.extra)}


def cascade_report(event: Any) -> Dict[str, Any]:
    """A :class:`~repro_torch.storage.repository.CascadeEvent` in the same
    schema (``kind="cascade"``)."""
    return {"kind": "cascade", "step": event.step,
            "phases": {"upload_s": event.t_end - event.t_start},
            "bytes": {"uploaded": event.nbytes},
            "counts": {}, "extra": {"tier": event.tier}}
