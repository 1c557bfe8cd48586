"""IPC layer for the process-per-rank runtime: faults, errors, payloads.

Everything that crosses the parent↔child pipe lives here, so both sides
agree on the wire shapes without importing each other's modules:

* :class:`ProcessFaultSpec` — a *picklable* fault to ship to a child
  (the closure-based ``fault_hook`` of the thread runtime cannot cross a
  process boundary); the child fires it at named protocol points with a
  real ``SIGKILL``, which is the whole point of the process runtime —
  the blast radius of a dying rank is one OS process, not a thread that
  python cannot actually kill.
* :class:`ProcessDied` / :class:`RemoteRankError` — parent-side
  exceptions distinguishing "the process vanished" (sentinel fired /
  pipe EOF) from "the child caught an exception and reported it".
* :func:`encode_record` / :func:`decode_record` — ShardRecord transport.
  Encoding copies a device shard to host memory explicitly (the D2H copy
  that the in-process engine would do on its stage lane happens at ship
  time instead; a bfloat16 shard travels as its raw ``uint16`` words
  beside the port's dtype name, never as an ``ml_dtypes`` array, which
  the card's host lacks), and reduces a
  :class:`~repro_torch.core.registry.ProviderRoute` to its picklable
  fields. Registry-attached provider *factories* are
  refused: a callable cannot cross the boundary, and silently dropping
  it would change what the child writes.

Wire protocol (tuples, pickled by ``multiprocessing.Connection``):

parent → child::

    ("save", step, directory, [record_payload...], objects, delta, trace)
    <each record's bytes, in order, in raw messages of at most
     PIPE_PIECE_BYTES>
    ("close",)

A record's payload travels with ``data`` set to its array's ``(dtype,
shape)``; the bytes follow the message (:func:`send_arrays`,
:func:`recv_array`). ``Connection.recv`` reads a message with ``os.read``
calls each sized to what is left of the message, and each allocates that
much: a message of a 1.3 GB shard made the child's reads crawl on the
card's host, where pieces of 16 MiB stream at the pipe's rate.

child → parent::

    ("ready", pid, perf_counter_at_ready)
    ("prepared", step, stats_dict, trace_events)
    ("failed", step, exc_repr, traceback_str, trace_events)
    ("closed",)

Replies carry ``step`` so the parent can discard stale messages from a
save it already abandoned (watchdog timeout) without misattributing them
to the next save.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

#: bytes of one raw message of a record's data
PIPE_PIECE_BYTES = 16 << 20

#: Protocol points a ProcessFaultSpec may name, in order. ``after_vote``
#: and ``before_ack`` are the same window (vote durable, ack never sent)
#: seen from the two phases' perspectives; both names are accepted.
PROCESS_FAULT_POINTS = ("mid_file", "after_upload", "after_vote",
                        "before_ack")

#: Fault actions: ``sigkill`` delivers an uncatchable SIGKILL to the
#: child itself; ``stall`` sleeps (watchdog-timeout territory).
PROCESS_FAULT_ACTIONS = ("sigkill", "stall")


@dataclasses.dataclass(frozen=True)
class ProcessFaultSpec:
    """A deterministic fault one child process fires on itself.

    ``step=None`` fires on the first save that reaches ``point``;
    otherwise only the named step triggers. ``mid_file`` first truncates
    the rank's own ``.dsllm`` file (torn write) before the kill, so the
    on-disk damage matches a node dying mid-flush, not just mid-protocol.
    """

    point: str
    rank: int
    step: Optional[int] = None
    action: str = "sigkill"
    stall_s: float = 600.0

    def __post_init__(self):
        if self.point not in PROCESS_FAULT_POINTS:
            raise ValueError(
                f"unknown fault point {self.point!r} "
                f"(choose from {PROCESS_FAULT_POINTS})")
        if self.action not in PROCESS_FAULT_ACTIONS:
            raise ValueError(
                f"unknown fault action {self.action!r} "
                f"(choose from {PROCESS_FAULT_ACTIONS})")

    def should_fire(self, point: str, rank: int, step: int) -> bool:
        return (point == self.point and rank == self.rank
                and (self.step is None or step == self.step))


class ProcessDied(RuntimeError):
    """A rank's worker process vanished (SIGKILL, OOM-kill, crash)."""

    def __init__(self, rank: int, exitcode: Optional[int]):
        super().__init__(
            f"rank {rank} worker process died (exitcode={exitcode})")
        self.rank = rank
        self.exitcode = exitcode


class RemoteRankError(RuntimeError):
    """An exception raised *inside* a worker, re-raised parent-side."""

    def __init__(self, rank: int, exc_repr: str, tb: str = ""):
        super().__init__(f"rank {rank} save failed: {exc_repr}")
        self.rank = rank
        self.exc_repr = exc_repr
        self.tb = tb


def encode_route(route: Any, tensor_name: str
                 ) -> Optional[Dict[str, Any]]:
    """Reduce a ProviderRoute to picklable fields (refusing factories)."""
    if route is None:
        return None
    if getattr(route, "factory", None) is not None:
        raise ValueError(
            f"record {tensor_name!r}: registry-attached provider "
            f"factories cannot cross the process boundary; run "
            f"factory-routed state under the thread runtime")
    return {"provider": route.provider,
            "options": tuple(route.options or ()),
            "rule_index": route.rule_index}


def encode_record(rec: Any) -> Dict[str, Any]:
    """ShardRecord → picklable payload: the shard's bytes as a host array
    of its dtype's storage (one blocking device-to-host copy of a card
    tensor; bfloat16 as plain ``uint16`` words, named by ``dtype``)."""
    import numpy as np
    import torch

    from repro_torch.core import dtypes
    storage = dtypes.lookup(rec.dtype).storage
    if isinstance(rec.data, torch.Tensor):
        data = dtypes.host_copy(rec.data.detach()).view(storage)
    else:
        data = np.ascontiguousarray(rec.data).view(storage)
    return {
        "leaf_path": rec.leaf_path,
        "tensor_name": rec.tensor_name,
        "rank": rec.rank,
        "index": tuple(rec.index),
        "global_shape": tuple(rec.global_shape),
        "shape": tuple(rec.shape),
        "dtype": rec.dtype,
        "nbytes": int(rec.nbytes),
        "data": data,
        "domain": rec.domain,
        "route": encode_route(rec.route, rec.tensor_name),
    }


def send_arrays(conn: Any, arrays: List[Any]) -> None:
    """Each array's bytes, in order, in raw messages of at most
    :data:`PIPE_PIECE_BYTES`."""
    import numpy as np
    for a in arrays:
        view = memoryview(np.ascontiguousarray(a).reshape(-1).view(np.uint8))
        for lo in range(0, len(view), PIPE_PIECE_BYTES):
            conn.send_bytes(view[lo:lo + PIPE_PIECE_BYTES])


def recv_array(conn: Any, dtype: str, shape: Tuple[int, ...]) -> Any:
    """One array sent by :func:`send_arrays`, received in place."""
    import numpy as np
    out = np.empty(shape, dtype)
    view = memoryview(out.reshape(-1).view(np.uint8))
    pos = 0
    while pos < len(view):
        pos += conn.recv_bytes_into(view, pos)
    return out


def decode_record(payload: Dict[str, Any]) -> Any:
    """Payload → ShardRecord (child side; data is already host-resident)."""
    from repro_torch.core.distributed import ShardRecord
    from repro_torch.core.registry import ProviderRoute
    rp = payload.get("route")
    route = None
    if rp is not None:
        route = ProviderRoute(provider=rp["provider"],
                              options=tuple(rp["options"]),
                              rule_index=rp["rule_index"])
    return ShardRecord(
        leaf_path=payload["leaf_path"],
        tensor_name=payload["tensor_name"],
        rank=payload["rank"],
        index=payload["index"],
        global_shape=payload["global_shape"],
        shape=payload["shape"],
        dtype=payload["dtype"],
        nbytes=payload["nbytes"],
        data=payload["data"],
        device_resident=False,
        domain=payload["domain"],
        route=route)


#: CheckpointStats fields shipped back in ``prepared`` replies; the
#: parent replays them onto a fresh future for _SaveJob._merge_stats.
STATS_FIELDS: Tuple[str, ...] = (
    "n_files", "n_tensors", "bytes_tensors", "bytes_objects",
    "serialize_s", "stage_s", "flush_s")

#: stats.extra keys worth shipping: step-manifest meta inputs, the
#: child's peak device memory on a card and its kernel launches in the
#: save (``kernels.build.launch_counts``).
STATS_EXTRA_KEYS: Tuple[str, ...] = ("domains", "file_domains",
                                     "device_peak_bytes", "kernel_launches")


def encode_stats(stats: Any) -> Dict[str, Any]:
    out = {k: getattr(stats, k) for k in STATS_FIELDS}
    out["extra"] = {k: v for k, v in stats.extra.items()
                    if k in STATS_EXTRA_KEYS}
    return out


def apply_stats(stats: Any, payload: Dict[str, Any]) -> None:
    for k in STATS_FIELDS:
        if k in payload:
            setattr(stats, k, payload[k])
    stats.extra.update(payload.get("extra") or {})
