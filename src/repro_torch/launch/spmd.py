"""Spawn N ranks, each in one ``torch.distributed`` process group, and run
functions on all of them (the counterpart of the JAX package's one
controller over forced host devices, ``tests/conftest.py``).

PyTorch's ``DTensor`` is multi-controller: each process holds its own
rank's shard and the ranks meet in collectives. :class:`SpmdGroup` starts
``world`` children (spawned, never forked: a fork after CUDA has started
breaks the child's CUDA), each joining one group at
``tcp://localhost:<free port>`` under ``backend``, and then serves calls:
:meth:`SpmdGroup.run` sends a picklable function and its arguments to
every rank and returns each rank's result, in rank order. The group lives
until :meth:`SpmdGroup.close`, so one set of ranks serves many calls.

A rank that raises fails the call: every rank's error comes back in one
:class:`SpmdError`, and the group is torn down (the survivors may be
waiting in a collective the failed rank never reaches). A rank that dies
fails the call the same way. A ``cuda`` group asks for the card in every
rank before it reports ready; a rank that cannot reach it dies, and the
group fails to start. Nothing falls back to the CPU unless the caller
asks for it.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import socket
import traceback
from multiprocessing import connection as mp_connection
from typing import Any, Callable, List, Optional


class SpmdError(RuntimeError):
    """One or more ranks of an :class:`SpmdGroup` failed a call."""


def free_port() -> int:
    """A TCP port on ``localhost`` that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(conn: Any, rank: int, world: int, port: int, backend: str,
               device: str, threads: Optional[int],
               timeout_s: float) -> None:
    import torch
    import torch.distributed as dist
    if threads:
        torch.set_num_threads(threads)
    try:
        from repro_torch.core.checkpoint import resolve_device
        dev = resolve_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{port}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
    except BaseException as exc:  # noqa: BLE001 — reported, then exit
        conn.send(("failed", repr(exc), traceback.format_exc()))
        conn.close()
        return
    conn.send(("ready", os.getpid()))
    try:
        while True:
            try:
                msg = conn.recv()
            except EOFError:
                return
            if msg[0] == "close":
                from repro_torch.sharding import gloo_cuda
                gloo_cuda.release()
                return
            _, fn, args, kwargs = msg
            try:
                conn.send(("done", fn(*args, **kwargs)))
            except BaseException as exc:  # noqa: BLE001 — report it
                conn.send(("failed", repr(exc), traceback.format_exc()))
    finally:
        try:
            dist.destroy_process_group()
        finally:
            conn.close()


class SpmdGroup:
    """``world`` spawned ranks in one process group on ``device`` (the
    card unless the caller asks for ``"cpu"``) under ``backend``;
    ``threads`` caps each rank's intra-op threads; ``timeout_s`` bounds a
    collective and the wait for one call."""

    def __init__(self, world: int, *, backend: str = "gloo",
                 device: str = "cuda", threads: Optional[int] = None,
                 timeout_s: float = 600.0):
        if world < 1:
            raise ValueError(f"world must be >= 1, got {world}")
        self.world = world
        self.timeout_s = timeout_s
        self._pending: Optional[str] = None
        ctx = multiprocessing.get_context("spawn")
        port = free_port()
        self._conns = []
        self._procs = []
        for r in range(world):
            parent, child = ctx.Pipe(duplex=True)
            p = ctx.Process(target=_rank_main,
                            args=(child, r, world, port, backend,
                                  str(device), threads, timeout_s),
                            daemon=True, name=f"spmd-rank{r}")
            p.start()
            child.close()
            self._conns.append(parent)
            self._procs.append(p)
        self.pids = [msg[1] for msg in self._gather("start")]

    def _gather(self, what: str) -> List[Any]:
        """One reply from every rank, in rank order; any failure or death
        tears the group down and raises :class:`SpmdError`."""
        replies: List[Any] = [None] * self.world
        pending = dict(enumerate(self._conns))
        errors = []
        deadline = self.timeout_s + 60.0
        while pending:
            waitables = list(pending.values()) + [
                self._procs[r].sentinel for r in pending]
            ready = mp_connection.wait(waitables, timeout=deadline)
            if not ready:
                errors.append(f"ranks {sorted(pending)} sent nothing in "
                              f"{deadline:.0f} s")
                break
            for r in list(pending):
                conn = pending[r]
                if conn in ready or conn.poll():
                    try:
                        msg = conn.recv()
                    except EOFError:
                        msg = ("failed", "EOFError", "the rank closed its "
                               "pipe")
                    del pending[r]
                    if msg[0] == "failed":
                        errors.append(f"rank {r}: {msg[1]}\n{msg[2]}")
                    else:
                        replies[r] = msg
                elif self._procs[r].sentinel in ready:
                    del pending[r]
                    errors.append(f"rank {r} died (exit code "
                                  f"{self._procs[r].exitcode})")
            if errors:
                break
        if errors:
            self.close(force=True)
            raise SpmdError(f"{what}: " + "\n".join(errors))
        return replies

    def run(self, fn: Callable, *args, **kwargs) -> List[Any]:
        """``fn(*args, **kwargs)`` on every rank; each rank's return
        value, in rank order (they cross a pipe, so return CPU tensors or
        numpy)."""
        self.start(fn, *args, **kwargs)
        return self.results()

    def start(self, fn: Callable, *args, **kwargs) -> None:
        """Send ``fn(*args, **kwargs)`` to every rank and return at once:
        the caller works on while the ranks run, then takes the values
        with :meth:`results`. One call at a time."""
        if not self._procs:
            raise SpmdError("the group is closed")
        if self._pending is not None:
            raise SpmdError(f"{self._pending} is still running")
        for conn in self._conns:
            conn.send(("call", fn, args, kwargs))
        self._pending = getattr(fn, "__name__", repr(fn))

    def results(self) -> List[Any]:
        """Each rank's return value of the call :meth:`start` sent."""
        what, self._pending = self._pending, None
        if what is None:
            raise SpmdError("no call is running")
        return [msg[1] for msg in self._gather(what)]

    def close(self, force: bool = False) -> None:
        """Stop every rank (``force``: kill them at once; a rank still
        running 30 s after ``close`` is killed)."""
        for conn in self._conns:
            if not force:
                try:
                    conn.send(("close",))
                except (OSError, ValueError, BrokenPipeError):
                    pass
        for p in self._procs:
            p.join(0 if force else 30)
            if p.is_alive():
                p.kill()
                p.join()
        for conn in self._conns:
            conn.close()
        self._conns, self._procs = [], []

    def __enter__(self) -> "SpmdGroup":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
