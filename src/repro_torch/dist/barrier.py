"""Failure-aware collective barrier for simulated multi-rank checkpointing.

``threading.Barrier`` almost fits, but a checkpoint barrier has two extra
requirements the stdlib one handles poorly:

* **poisoning with a cause** — when one rank dies mid-save, every peer
  (and the coordinator) must wake immediately with the *originating*
  exception, not a bare ``BrokenBarrierError``;
* **external observers** — the coordinator is not a party to the barrier
  but needs to wait for a generation to complete (or break) with its own
  timeout, so a stalled rank turns into a clean ``TimeoutError`` instead
  of a wedged training loop.

The barrier is reusable (generation-counted) like the stdlib one; once
poisoned it stays broken until :meth:`reset`, because a collective whose
membership already failed cannot silently heal.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from repro_torch.analysis.locks import declares_lock


class BarrierBroken(RuntimeError):
    """The collective failed: some party poisoned the barrier."""

    def __init__(self, reason: str, rank: Optional[int] = None):
        super().__init__(reason)
        self.rank = rank


@declares_lock("barrier.cond", rank=20, attrs=("_cond",))
class CollectiveBarrier:
    """Reusable N-party barrier with poisoning and observer waits."""

    def __init__(self, parties: int):
        if parties < 1:
            raise ValueError(f"parties must be >= 1, got {parties}")
        self.parties = parties
        self._cond = threading.Condition()
        self._arrived = 0
        self._generation = 0
        self._broken: Optional[BarrierBroken] = None

    # ------------------------------------------------------------- parties
    def wait(self, timeout: Optional[float] = None) -> int:
        """Block until all parties arrive; returns the generation that
        completed. Raises :class:`BarrierBroken` if poisoned (before or
        while waiting) and ``TimeoutError`` on timeout — a timeout also
        poisons the barrier, since the collective can no longer complete
        with one party gone."""
        # Single monotonic deadline for the whole wait: Condition.wait()
        # restarts its clock on every wakeup, and wakeups that change
        # nothing (poison→reset cycles, adjacent generations completing)
        # would otherwise extend the total wait without bound.
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            if self._broken is not None:
                raise self._broken
            gen = self._generation
            self._arrived += 1
            if self._arrived == self.parties:
                self._arrived = 0
                self._generation += 1
                self._cond.notify_all()
                return gen
            while self._generation == gen and self._broken is None:
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0 \
                        or not self._cond.wait(remaining):
                    self._broken = BarrierBroken(
                        f"barrier timed out in generation {gen} "
                        f"({self._arrived}/{self.parties} arrived)")
                    self._cond.notify_all()
                    raise TimeoutError(str(self._broken))
            if self._broken is not None:
                raise self._broken
            return gen

    def poison(self, reason: str, rank: Optional[int] = None) -> None:
        """Break the collective: every current and future waiter raises
        :class:`BarrierBroken` carrying ``reason`` until :meth:`reset`."""
        with self._cond:
            if self._broken is None:
                self._broken = BarrierBroken(reason, rank=rank)
            self._cond.notify_all()

    # ----------------------------------------------------------- observers
    def wait_generation(self, generation: int,
                        timeout: Optional[float] = None) -> None:
        """Observer wait (coordinator side): block until ``generation`` has
        completed. Raises :class:`BarrierBroken` if poisoned, or
        ``TimeoutError`` (without poisoning — the observer is not a party;
        the caller decides whether a late collective is fatal)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self._generation <= generation:
                if self._broken is not None:
                    raise self._broken
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0 \
                        or not self._cond.wait(remaining):
                    raise TimeoutError(
                        f"generation {generation} did not complete "
                        f"({self._arrived}/{self.parties} arrived)")
            if self._broken is not None:
                raise self._broken

    # ------------------------------------------------------------- control
    @property
    def broken(self) -> bool:
        with self._cond:
            return self._broken is not None

    @property
    def generation(self) -> int:
        with self._cond:
            return self._generation

    def reset(self) -> None:
        """Heal a poisoned barrier (tests / rank-replacement recovery)."""
        with self._cond:
            self._broken = None
            self._arrived = 0
            self._cond.notify_all()
