"""Runtime lock-order witness: validates the declared hierarchy against
real executions.

The static pass (:mod:`repro_torch.analysis.lockorder`) proves properties of the
*source*; this module proves the declared ranks match what threads
actually do. While a recording is active, every lock declared with
:func:`repro_torch.analysis.locks.declares_lock` / ``named_lock`` is replaced by
a :class:`WitnessLock` proxy that maintains a per-thread stack of held
(name, rank) pairs. Acquiring a lock whose rank is not strictly greater
than every rank already held records a :class:`Violation` (it never
raises mid-test — a deadlock-prone ordering should fail the assertion at
the end of the test, not crash a worker thread halfway through a save).

The fault-injection suites run under a recording and assert zero
violations at teardown, so the hierarchy table in ``locks.py`` can never
silently drift from the code.

Usage::

    from repro_torch.analysis import witness
    with witness.recording() as w:
        ...  # construct engines/managers and exercise them
    assert not w.violations
"""

from __future__ import annotations

import contextlib
import threading
import traceback
from typing import Any, Iterator, List, Optional, Set, Tuple

__all__ = ["Violation", "LockWitness", "WitnessLock", "install",
           "uninstall", "current", "recording"]


class Violation:
    """One out-of-order acquisition observed at runtime."""

    def __init__(self, thread: str, held: List[Tuple[str, int]],
                 name: str, rank: int, stack: str):
        self.thread = thread
        self.held = list(held)
        self.name = name
        self.rank = rank
        self.stack = stack

    def __repr__(self) -> str:
        held = ", ".join(f"{n}(r{r})" for n, r in self.held)
        return (f"<lock-order violation in {self.thread}: acquired "
                f"{self.name}(r{self.rank}) while holding [{held}]>")

    def describe(self) -> str:
        return f"{self!r}\nacquired at:\n{self.stack}"


class LockWitness:
    """Collects per-thread acquisition order and hierarchy violations."""

    def __init__(self) -> None:
        self.violations: List[Violation] = []
        #: observed (held-name, acquired-name) nesting edges — useful for
        #: auditing which static edges real executions actually exercise
        self.edges: Set[Tuple[str, str]] = set()
        self.acquisitions = 0
        self._tls = threading.local()
        self._mu = threading.Lock()

    def _stack(self) -> List[Tuple[str, int]]:
        st = getattr(self._tls, "held", None)
        if st is None:
            st = self._tls.held = []
        return st

    def note_acquire(self, name: str, rank: int) -> None:
        held = self._stack()
        with self._mu:
            self.acquisitions += 1
        if held:
            top_name, top_rank = held[-1]
            with self._mu:
                self.edges.add((top_name, name))
            if name != top_name and rank <= max(r for _n, r in held):
                v = Violation(threading.current_thread().name, held,
                              name, rank,
                              "".join(traceback.format_stack(limit=12)))
                with self._mu:
                    self.violations.append(v)
        held.append((name, rank))

    def note_release(self, name: str) -> None:
        held = self._stack()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] == name:
                del held[i]
                return

    def assert_clean(self) -> None:
        if self.violations:
            raise AssertionError(
                "lock-order witness recorded hierarchy violations:\n"
                + "\n".join(v.describe() for v in self.violations))


class WitnessLock:
    """Recording proxy over a ``Lock``/``RLock``/``Condition``.

    Acquisition via ``with``/``acquire`` is recorded against the witness;
    everything else (``wait``, ``notify_all``, ...) delegates to the
    wrapped primitive. A ``Condition.wait`` releases the underlying lock
    internally but the proxy keeps it on the held stack — conceptually the
    lock is held around the wait, which is exactly the window lock-order
    reasoning cares about.
    """

    def __init__(self, name: str, rank: int, inner: Any,
                 witness: LockWitness):
        self._ckpt_name = name
        self._ckpt_rank = rank
        self._ckpt_inner = inner
        self._ckpt_witness = witness

    def acquire(self, *a: Any, **k: Any) -> Any:
        got = self._ckpt_inner.acquire(*a, **k)
        if got:
            self._ckpt_witness.note_acquire(self._ckpt_name,
                                            self._ckpt_rank)
        return got

    def release(self, *a: Any, **k: Any) -> Any:
        self._ckpt_witness.note_release(self._ckpt_name)
        return self._ckpt_inner.release(*a, **k)

    def __enter__(self) -> Any:
        got = self._ckpt_inner.__enter__()
        self._ckpt_witness.note_acquire(self._ckpt_name, self._ckpt_rank)
        return got

    def __exit__(self, *exc: Any) -> Any:
        self._ckpt_witness.note_release(self._ckpt_name)
        return self._ckpt_inner.__exit__(*exc)

    def __getattr__(self, item: str) -> Any:
        return getattr(self._ckpt_inner, item)


_current: Optional[LockWitness] = None
_install_mu = threading.Lock()


def current() -> Optional[LockWitness]:
    """The active witness, or None when not recording (the common case)."""
    return _current


def install() -> LockWitness:
    """Start recording. Locks constructed *after* this point are
    instrumented; objects built earlier keep their plain locks."""
    global _current
    with _install_mu:
        if _current is None:
            _current = LockWitness()
        return _current


def uninstall() -> Optional[LockWitness]:
    global _current
    with _install_mu:
        w, _current = _current, None
        return w


@contextlib.contextmanager
def recording() -> Iterator[LockWitness]:
    """Record for the duration of a ``with`` block (test fixture form)."""
    w = install()
    try:
        yield w
    finally:
        uninstall()
