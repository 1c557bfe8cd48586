"""Child-process entry point for the process-per-rank runtime.

One spawned process per writer rank runs :func:`worker_main`: build this
rank's engine, report ``ready`` (with a ``perf_counter`` sample for the
parent's trace clock alignment), then serve ``save`` requests until
``close`` or pipe EOF. The *protocol brain* — barriers, node manifests,
watchdog, the aggregated future — stays in the parent; the child only
does the work a real rank would do locally: drain its shards through its
own engine, write its rank file, and cast its phase-1 vote. The ack is
the ``prepared`` reply itself — the parent-side proxy meets the
collective on the child's behalf.

Fault injection (:class:`~repro_torch.dist.ipc.ProcessFaultSpec`) is fired
*here*, child-side, with ``os.kill(os.getpid(), SIGKILL)`` — uncatchable
and instant, exactly the failure mode a preempted node presents. The
``mid_file`` point tears the rank's own file first (``os.truncate`` to
half size) so the orphaned step carries real on-disk damage.

The child builds its engine on the device the parent names: its host
cache is pinned for that card and its checksum launches run there, on a
stream of the child's own. A child that cannot reach the card dies before
``ready``; the parent sees the corpse and the save fails, and so does a
child whose configured rendezvous fails (``torch_distributed``). Each
``prepared``
reply carries the save's kernel launches (counted from zero at the save)
and, on a card, the child's peak device memory.

Module-top imports stay light (stdlib only): the spawn bootstrap imports
this module before the parent learns whether the child even started, and
the heavy stack (numpy/torch/engine) loads inside :func:`worker_main`
where failures are reportable over the pipe.
"""

from __future__ import annotations

import os
import signal
import time
import traceback
from typing import Any, Dict, List, Optional


def _fire_fault(fault: Any, point: str, rank: int, step: int,
                directory: str, filenames: List[str]) -> None:
    if fault is None or not fault.should_fire(point, rank, step):
        return
    if fault.action == "stall":
        time.sleep(fault.stall_s)
        return
    if point == "mid_file":
        # torn write: the file exists at a plausible-but-short size, as
        # if the node died with flush buffers in flight
        for name in filenames:
            path = os.path.join(directory, name)
            try:
                size = os.path.getsize(path)
                os.truncate(path, max(size // 2, 1))
            except OSError:
                pass
    os.kill(os.getpid(), signal.SIGKILL)


#: seconds a rank waits for the process group's rendezvous
RENDEZVOUS_TIMEOUT_S = 60.0


def join_process_group(rank: int, world: int) -> Optional[int]:
    """Join the ``torch.distributed`` group the environment configures
    (``env://``: ``MASTER_ADDR`` and ``MASTER_PORT``; gloo, which takes
    host and CUDA tensors alike) as ``rank`` of ``world``, so a device
    mesh can span the rank processes; the counterpart of the reference's
    ``jax.distributed.initialize()``. With no rendezvous configured it
    joins nothing and returns ``None``, as the reference's rank does; a
    rendezvous that is configured and fails raises (the reference
    swallows every error). :data:`RENDEZVOUS_TIMEOUT_S` bounds the
    rendezvous. Returns the group's world."""
    if not os.environ.get("MASTER_ADDR"):
        return None
    import datetime

    import torch.distributed as dist
    dist.init_process_group(
        "gloo", init_method="env://", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=RENDEZVOUS_TIMEOUT_S))
    return dist.get_world_size()


def worker_main(conn: Any, rank: int, world: int, mode: str,
                device: str, engine_kw: Dict[str, Any],
                checksum_files: bool, fault: Optional[Any] = None,
                torch_distributed: bool = False) -> None:
    """Serve one rank's saves over ``conn`` until close/EOF; with
    ``torch_distributed``, first join the configured process group
    (:func:`join_process_group`)."""
    group_world = join_process_group(rank, world) if torch_distributed \
        else None
    from repro_torch.core.baselines import rank_file
    from repro_torch.core.checkpoint import resolve_device
    from repro_torch.core.engine import CheckpointFuture
    from repro_torch.dist.ipc import decode_record, encode_stats, recv_array
    from repro_torch.dist.runtime import RANK_ENGINES
    from repro_torch.kernels import build
    from repro_torch.kernels.ops import lane_stream
    from repro_torch.obs import trace as obs
    from repro_torch.storage.manifest import RankManifest

    lane = f"rank{rank:05d}"
    dev = resolve_device(device)
    engine = RANK_ENGINES[mode](device=dev, label=lane, **engine_kw)
    conn.send(("ready", os.getpid(), time.perf_counter(), group_world))
    try:
        with lane_stream(dev):
            while True:
                try:
                    msg = conn.recv()
                except EOFError:
                    return
                if msg[0] == "close":
                    return
                if msg[0] != "save":
                    continue
                _, step, directory, payload, objects, delta, trace = msg
                # the records' bytes follow the message; a child that
                # cannot take them all dies, and the parent sees it
                for p in payload:
                    p["data"] = recv_array(conn, *p["data"])
                tracer = obs.enable() if trace else None
                # this save's launches only, shipped in the reply
                build.zero_launches()
                try:
                    records = [decode_record(p) for p in payload]
                    fut = CheckpointFuture(step, directory)
                    engine.save(directory, {rank: records}, objects, fut,
                                delta=delta)
                    fut.wait_captured()
                    fut.wait_persisted()
                    files = [os.path.basename(rank_file(directory, rank))]
                    _fire_fault(fault, "mid_file", rank, step, directory,
                                files)
                    _fire_fault(fault, "after_upload", rank, step,
                                directory, files)
                    with obs.span("vote", lane=lane, step=step, rank=rank):
                        vote = RankManifest.build(
                            directory, rank=rank, world=world, step=step,
                            filenames=files, device=dev,
                            checksum=checksum_files,
                            precomputed=fut.stats.extra.get(
                                "file_checksums"))
                        vote.write(directory)
                    _fire_fault(fault, "after_vote", rank, step, directory,
                                files)
                    _fire_fault(fault, "before_ack", rank, step, directory,
                                files)
                    if dev.type == "cuda":
                        import torch
                        fut.stats.extra["device_peak_bytes"] = \
                            torch.cuda.max_memory_allocated(dev)
                    fut.stats.extra["kernel_launches"] = \
                        build.launch_counts()
                    events = tracer.events() if tracer is not None else []
                    conn.send(("prepared", step, encode_stats(fut.stats),
                               events))
                except BaseException as exc:  # noqa: BLE001 — report it
                    events = tracer.events() if tracer is not None else []
                    try:
                        conn.send(("failed", step, repr(exc),
                                   traceback.format_exc(), events))
                    except (OSError, ValueError, BrokenPipeError):
                        return
                finally:
                    if tracer is not None:
                        obs.disable()
    finally:
        try:
            engine.close()
        except Exception:  # noqa: BLE001 — teardown of a failing rank
            pass
        try:
            conn.send(("closed",))
        except (OSError, ValueError, BrokenPipeError):
            pass
        conn.close()
        if group_world is not None:
            import torch.distributed as dist
            dist.destroy_process_group()
