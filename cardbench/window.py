"""The reduction of a traced window: ``torch.profiler`` over the window
with device activity only, the program's host spans beside it. Gives the
seconds in which the card ran anything (kernels, copies, fills; the
union of their intervals), each kernel's device time and count by name,
the device operations that took most time, and the idle time by what
the host's main thread was doing then."""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, List, Tuple

import torch


#: a device operation's name is cut to this many characters in the
#: breakdown (template arguments make some run past a thousand)
NAME_CHARS = 120


class Window:
    """``with Window(trace) as w:`` around the window. With ``trace``
    False it only times; with ``trace`` True it also records the card's
    activity and the program's spans, reduced by :meth:`summary`."""

    def __init__(self, trace: bool):
        self.trace = trace
        self.prof = None
        self.tracer = None
        self._stack = contextlib.ExitStack()
        self.t0 = self.t1 = 0.0
        self.t_mark = 0.0

    def __enter__(self) -> "Window":
        if self.trace:
            from repro_torch.obs import trace as obs
            from torch.profiler import ProfilerActivity, profile
            self.tracer = self._stack.enter_context(obs.tracing())
            self.prof = self._stack.enter_context(
                profile(activities=[ProfilerActivity.CUDA]))
            torch.cuda.synchronize()
            # the first device operation of the trace: it ties the
            # trace's clock to the host's
            self.t_mark = time.perf_counter()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = time.perf_counter()
        if self.trace:
            torch.cuda.synchronize()
        self._stack.close()
        return False

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def summary(self) -> Dict[str, Any]:
        """``busy_s``, ``kernels`` ({name: [count, seconds]}),
        ``device_ops`` and ``idle_gaps`` (at most 10 ``[name, seconds]``
        each) over the window."""
        evs = device_events(self.prof)
        if not evs:
            return {"busy_s": 0.0, "kernels": {}, "device_ops": [],
                    "idle_gaps": []}
        mark = min(evs, key=lambda e: e[1])
        # trace microseconds of a host time
        def at(t: float) -> float:
            return mark[1] + (t - self.t_mark) * 1e6
        lo, hi = at(self.t0), at(self.t1)
        evs = [e for e in evs if e[2] > lo and e[1] < hi]
        kernels: Dict[str, List[float]] = {}
        for name, a, b in evs:
            k = kernels.setdefault(name, [0, 0.0])
            k[0] += 1
            k[1] += (min(b, hi) - max(a, lo)) / 1e6
        busy, gaps = _union(sorted((max(a, lo), min(b, hi))
                                   for _n, a, b in evs), lo, hi)
        top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
        return {"busy_s": busy / 1e6, "kernels": kernels,
                "device_ops": [[n[:NAME_CHARS], v[1]] for n, v in top],
                "idle_gaps": self._idle_by_span(gaps, at)}

    def _idle_by_span(self, gaps: List[Tuple[float, float]], at
                      ) -> List[List[Any]]:
        spans = [(at(s["t0"]), at(s["t1"]), s["name"])
                 for s in self.tracer.spans() if s["lane"] == "MainThread"]
        by: Dict[str, float] = {}
        for a, b in gaps:
            mid = (a + b) / 2
            inner = [s for s in spans if s[0] <= mid < s[1]]
            name = min(inner, key=lambda s: s[1] - s[0])[2] if inner \
                else "outside the program's spans"
            by[name] = by.get(name, 0.0) + (b - a) / 1e6
        return [[n, s] for n, s in
                sorted(by.items(), key=lambda kv: -kv[1])[:10]]


def device_events(prof) -> List[Tuple[str, float, float]]:
    """``(name, start, end)`` in microseconds of every device operation
    the profiler saw, from its raw events (``prof.events()`` builds an
    object an event, about a minute for a 40 s window)."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.start_ns() / 1e3,
             (e.start_ns() + e.duration_ns()) / 1e3)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda]


def _union(iv: List[Tuple[float, float]], lo: float, hi: float
           ) -> Tuple[float, List[Tuple[float, float]]]:
    """Covered length of sorted intervals, and the gaps between them."""
    busy, gaps = 0.0, []
    end = lo
    for a, b in iv:
        if a > end:
            gaps.append((end, a))
        if b > end:
            busy += b - max(a, end)
            end = b
    if hi > end:
        gaps.append((end, hi))
    return busy, gaps


def kernel_seconds(kernels: Dict[str, List[float]], *needles: str
                   ) -> Tuple[int, float]:
    """Count and device seconds of the kernels whose name holds any of
    ``needles``."""
    n, s = 0, 0.0
    for name, (c, t) in kernels.items():
        if any(x in name for x in needles):
            n += int(c)
            s += t
    return n, s
