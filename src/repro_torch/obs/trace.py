"""Thread-aware span tracing with Chrome trace-event (Perfetto) export.

Design constraints:

* **Off by default, near-free when off.** ``span(...)`` reads one module
  global; when no tracer is installed it returns a shared no-op context
  manager. The enforced budget is <1% of iteration time for the training
  loop's instrumentation density (``tests/test_obs.py``).
* **Lock-free-ish hot path.** Each thread appends to its *own* ring buffer
  (plain list mutation — no lock, no contention). The only lock —
  ``obs.trace_registry`` (rank 80, above every runtime lock, see
  ``repro_torch.analysis.locks``) — guards buffer registration (once per
  thread) and export snapshots. It is therefore always legal to record a span while
  holding any engine/repository/cache lock, and ckptlint's blocking-under-
  lock rule holds: export snapshots under the lock, file I/O happens after
  it is released.
* **Bounded.** Rings have a fixed per-thread capacity; on overflow the
  oldest events are overwritten and a drop counter is kept (exported in the
  trace metadata) — tracing can be left on for a long run without growing
  without bound.
* **Lanes.** Every event carries a *lane* — by default the recording
  thread's name (the engine already names its lanes: ``dsllm-stage``,
  ``dsllm-producer-i``, ``dsllm-flush-i``, ``ckpt-commit``, …); call sites
  may override (the coordinator tags per-rank work ``rank00000``…). Export
  emits one Chrome track per lane via ``thread_name`` metadata events.
* **Flows.** Cross-lane causality (capture→D2H→encode→flush→commit;
  restore index→plan→read→assemble) is linked with Chrome flow events
  (``ph: s/t/f``) keyed by :func:`flow_id`.

Usage::

    from repro_torch.obs import span, tracing

    with tracing("out.json"):          # enable + export on exit
        with span("encode", step=3, rank=0, bytes=1 << 20):
            ...
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.analysis.locks import declares_lock

__all__ = [
    "Tracer", "span", "add_span", "instant", "counter", "flow_id",
    "enable", "disable", "enabled", "get_tracer", "tracing",
]

# Event tuple layout (kept a plain tuple — hot-path allocation cost):
#   (ph, name, t0, dur, lane, tid, args, flow, flow_phase)
# ph: "X" complete span | "i" instant | "C" counter
# t0/dur: time.perf_counter() seconds; export converts to µs vs. origin.
_Event = Tuple[str, str, float, float, str, int, Optional[Dict[str, Any]],
               Optional[str], str]

DEFAULT_CAPACITY = 1 << 16  # events per thread


class _ThreadBuffer:
    """Fixed-capacity ring owned by exactly one writer thread."""

    __slots__ = ("events", "capacity", "head", "dropped", "lane", "tid")

    def __init__(self, capacity: int, lane: str, tid: int):
        self.events: List[_Event] = []
        self.capacity = capacity
        self.head = 0           # overwrite cursor once full (oldest event)
        self.dropped = 0
        self.lane = lane        # thread name at registration = default lane
        self.tid = tid

    def add(self, ev: _Event) -> None:
        if len(self.events) < self.capacity:
            self.events.append(ev)
        else:
            self.events[self.head] = ev
            self.head = (self.head + 1) % self.capacity
            self.dropped += 1

    def snapshot(self) -> Tuple[List[_Event], int]:
        """Copy in ring order (oldest first). Safe to call from any thread:
        the owner only appends/overwrites single slots (atomic under the
        GIL), and the copy tolerates a concurrently-moving head."""
        evs = list(self.events)
        head = self.head
        if len(evs) >= self.capacity and head:
            evs = evs[head:] + evs[:head]
        return evs, self.dropped


@declares_lock("obs.trace_registry", rank=80, attrs=("_lock",))
class Tracer:
    """Per-process span recorder. Install via :func:`enable`."""

    def __init__(self, capacity_per_thread: int = DEFAULT_CAPACITY):
        self.capacity = int(capacity_per_thread)
        self.t_origin = time.perf_counter()
        self._lock = threading.Lock()
        self._buffers: List[_ThreadBuffer] = []
        self._tls = threading.local()

    # ------------------------------------------------------------- recording
    def _buffer(self) -> _ThreadBuffer:
        buf = getattr(self._tls, "buf", None)
        if buf is None:
            th = threading.current_thread()
            buf = _ThreadBuffer(self.capacity, th.name, th.ident or 0)
            with self._lock:
                self._buffers.append(buf)
            self._tls.buf = buf
        return buf

    def add_complete(self, name: str, t0: float, t1: float,
                     lane: Optional[str] = None,
                     args: Optional[Dict[str, Any]] = None,
                     flow: Optional[str] = None,
                     flow_phase: str = "step") -> None:
        buf = self._buffer()
        buf.add(("X", name, t0, t1 - t0, lane or buf.lane, buf.tid,
                 args or None, flow, flow_phase))

    def add_instant(self, name: str, lane: Optional[str] = None,
                    args: Optional[Dict[str, Any]] = None,
                    flow: Optional[str] = None,
                    flow_phase: str = "start") -> None:
        buf = self._buffer()
        buf.add(("i", name, time.perf_counter(), 0.0, lane or buf.lane,
                 buf.tid, args or None, flow, flow_phase))

    def add_counter(self, name: str, value: float,
                    lane: Optional[str] = None) -> None:
        buf = self._buffer()
        buf.add(("C", name, time.perf_counter(), 0.0, lane or buf.lane,
                 buf.tid, {"value": value}, None, "step"))

    def ingest(self, events: List[Dict[str, Any]], *,
               clock_offset: float = 0.0,
               default_lane: Optional[str] = None) -> None:
        """Merge foreign events (another process's ``Tracer.events()``)
        into this tracer's timeline.

        The process-per-rank runtime ships each child's spans back over
        the pipe; ``clock_offset`` (parent ``perf_counter`` minus the
        child's, measured at the ready handshake) maps their timestamps
        onto this process's clock so one export shows every rank.
        Lanes the child didn't name explicitly (its ``MainThread``)
        are relabeled to ``default_lane`` — the rank's lane — so child
        tracks sort with the rank's engine lanes in Perfetto.
        """
        for ev in events:
            if ev.get("ph") != "X":
                continue
            lane = ev.get("lane")
            if default_lane is not None and \
                    (not lane or lane == "MainThread"):
                lane = default_lane
            self.add_complete(
                ev["name"], ev["t0"] + clock_offset,
                ev["t1"] + clock_offset, lane=lane,
                args=ev.get("args") or None, flow=ev.get("flow"),
                flow_phase=ev.get("flow_phase") or "step")

    # --------------------------------------------------------------- reading
    def events(self) -> List[Dict[str, Any]]:
        """All recorded events as dicts (tests / breakdown analysis)."""
        out: List[Dict[str, Any]] = []
        for evs, _dropped in self._snapshots():
            for ph, name, t0, dur, lane, tid, args, flow, fph in evs:
                out.append({"ph": ph, "name": name, "t0": t0, "dur": dur,
                            "t1": t0 + dur, "lane": lane, "tid": tid,
                            "args": args or {}, "flow": flow,
                            "flow_phase": fph})
        out.sort(key=lambda e: e["t0"])
        return out

    def spans(self, name: Optional[str] = None) -> List[Dict[str, Any]]:
        """Complete spans only, optionally filtered by name prefix."""
        evs = [e for e in self.events() if e["ph"] == "X"]
        if name is not None:
            evs = [e for e in evs if e["name"] == name
                   or e["name"].startswith(name + ".")]
        return evs

    def dropped(self) -> int:
        return sum(d for _evs, d in self._snapshots())

    def _snapshots(self) -> List[Tuple[List[_Event], int]]:
        with self._lock:
            buffers = list(self._buffers)
        return [b.snapshot() for b in buffers]

    # ---------------------------------------------------------------- export
    def to_chrome(self) -> Dict[str, Any]:
        """Chrome trace-event JSON object (Perfetto / chrome://tracing)."""
        pid = os.getpid()
        origin = self.t_origin
        events = self.events()
        # One track per lane: stable synthetic tids in first-seen order.
        lane_tid: Dict[str, int] = {}
        for ev in events:
            lane_tid.setdefault(ev["lane"], len(lane_tid) + 1)
        out: List[Dict[str, Any]] = [{
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": "repro-ckpt"},
        }]
        for lane, tid in sorted(lane_tid.items(), key=lambda kv: kv[1]):
            out.append({"name": "thread_name", "ph": "M", "pid": pid,
                        "tid": tid, "args": {"name": lane}})
        for ev in events:
            ts = max(0.0, (ev["t0"] - origin) * 1e6)
            tid = lane_tid[ev["lane"]]
            if ev["ph"] == "X":
                rec = {"name": ev["name"], "ph": "X", "cat": "ckpt",
                       "ts": ts, "dur": max(0.0, ev["dur"] * 1e6),
                       "pid": pid, "tid": tid}
                if ev["args"]:
                    rec["args"] = ev["args"]
                out.append(rec)
                if ev["flow"] is not None:
                    fph = {"start": "s", "step": "t", "end": "f"}.get(
                        ev["flow_phase"], "t")
                    frec = {"name": "ckpt-flow", "ph": fph, "cat": "flow",
                            "id": ev["flow"], "ts": ts, "pid": pid,
                            "tid": tid}
                    if fph == "f":
                        frec["bp"] = "e"  # bind to enclosing slice
                    out.append(frec)
            elif ev["ph"] == "i":
                rec = {"name": ev["name"], "ph": "i", "cat": "ckpt",
                       "ts": ts, "pid": pid, "tid": tid, "s": "t"}
                if ev["args"]:
                    rec["args"] = ev["args"]
                out.append(rec)
                if ev["flow"] is not None:
                    fph = {"start": "s", "step": "t", "end": "f"}.get(
                        ev["flow_phase"], "t")
                    out.append({"name": "ckpt-flow", "ph": fph,
                                "cat": "flow", "id": ev["flow"], "ts": ts,
                                "pid": pid, "tid": tid})
            elif ev["ph"] == "C":
                out.append({"name": ev["name"], "ph": "C", "cat": "ckpt",
                            "ts": ts, "pid": pid, "tid": 0,
                            "args": ev["args"]})
        return {"traceEvents": out, "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped()}}

    def export(self, path: str) -> str:
        """Write the Chrome JSON to ``path`` (no lock held during I/O)."""
        doc = self.to_chrome()  # snapshots under the lock, then releases
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(doc, fh)
        os.replace(tmp, path)
        return path


class _SpanHandle:
    __slots__ = ("_tracer", "_name", "_lane", "_flow", "_flow_phase",
                 "_args", "_t0")

    def __init__(self, tracer, name, lane, flow, flow_phase, args):
        self._tracer = tracer
        self._name = name
        self._lane = lane
        self._flow = flow
        self._flow_phase = flow_phase
        self._args = args

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        self._tracer.add_complete(self._name, self._t0, time.perf_counter(),
                                  lane=self._lane, args=self._args or None,
                                  flow=self._flow,
                                  flow_phase=self._flow_phase)
        return False


class _NoopSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NOOP = _NoopSpan()
_ACTIVE: Optional[Tracer] = None


# ------------------------------------------------------------- module API
def enabled() -> bool:
    return _ACTIVE is not None


def get_tracer() -> Optional[Tracer]:
    return _ACTIVE


def enable(capacity_per_thread: int = DEFAULT_CAPACITY) -> Tracer:
    """Install a fresh process-wide tracer and return it."""
    global _ACTIVE
    _ACTIVE = Tracer(capacity_per_thread)
    return _ACTIVE


def disable() -> Optional[Tracer]:
    """Uninstall the tracer; returns it so callers can still export."""
    global _ACTIVE
    t = _ACTIVE
    _ACTIVE = None
    return t


def span(name: str, lane: Optional[str] = None, flow: Optional[str] = None,
         flow_phase: str = "step", **args: Any):
    """Context manager recording one complete span (no-op when disabled)."""
    t = _ACTIVE
    if t is None:
        return _NOOP
    return _SpanHandle(t, name, lane, flow, flow_phase, args)


def add_span(name: str, t0: float, t1: float, lane: Optional[str] = None,
             flow: Optional[str] = None, flow_phase: str = "step",
             **args: Any) -> None:
    """Record a span from an existing perf_counter pair (no-op when
    disabled) — lets code that must keep wall-clock stats emit the same
    interval as a trace span without timing twice."""
    t = _ACTIVE
    if t is not None:
        t.add_complete(name, t0, t1, lane=lane, args=args or None,
                       flow=flow, flow_phase=flow_phase)


def instant(name: str, lane: Optional[str] = None,
            flow: Optional[str] = None, flow_phase: str = "start",
            **args: Any) -> None:
    t = _ACTIVE
    if t is not None:
        t.add_instant(name, lane=lane, args=args or None, flow=flow,
                      flow_phase=flow_phase)


def counter(name: str, value: float) -> None:
    """Record a counter sample (rendered as a counter track in Perfetto)."""
    t = _ACTIVE
    if t is not None:
        t.add_counter(name, value)


def flow_id(kind: str, step: int, rank: Optional[int] = None) -> str:
    """Stable flow-link id for one logical operation (e.g. one save)."""
    if rank is None:
        return f"{kind}-{step}"
    return f"{kind}-{step}-r{rank}"


class tracing:
    """``with tracing("out.json") as t:`` — enable, export+disable on exit.

    ``path=None`` enables without exporting (tests inspect ``t.events()``).
    Nesting-safe: on exit the previously-active tracer (if any) is
    restored, so a benchmark that records its own trace under a harness
    that already called ``tracing`` doesn't silently kill the outer one.
    """

    def __init__(self, path: Optional[str] = None,
                 capacity_per_thread: int = DEFAULT_CAPACITY):
        self.path = path
        self.capacity = capacity_per_thread
        self.tracer: Optional[Tracer] = None
        self._prev: Optional[Tracer] = None

    def __enter__(self) -> Tracer:
        self._prev = get_tracer()
        self.tracer = enable(self.capacity)
        return self.tracer

    def __exit__(self, exc_type, exc, tb):
        global _ACTIVE
        t = self.tracer
        if get_tracer() is t:
            _ACTIVE = self._prev
        self._prev = None
        if t is not None and self.path is not None:
            t.export(self.path)
        return False
