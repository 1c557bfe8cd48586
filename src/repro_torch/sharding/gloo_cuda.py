"""DTensor's collectives on CUDA tensors among ranks of one host under a
``gloo`` group, through staging buffers the ranks share.

Several ranks on one card cannot share an NCCL group (NCCL refuses two
ranks on one GPU: "Duplicate GPU detected"), so the port's ranks on a
one-card host meet over ``gloo``. ``DTensor`` redistributes through
PyTorch's functional collectives (``torch.ops._c10d_functional``): on
the H100 host's PyTorch 2.11 every rank dies with SIGSEGV in
``wait_tensor`` after a functional ``all_gather_into_tensor`` of a CUDA
tensor under gloo. ``DTensor`` moves a split from one dimension to
another (Ulysses' all-to-all) through
``torch.ops._dtensor.shard_dim_alltoall``, whose own implementation runs
the group's list ``alltoall``: on 2.11 with CUDA tensors under gloo the
rank dies in it too (on a ``cpu`` mesh ``DTensor`` takes an all-gather
instead).

:func:`install` registers, for the ``CUDA`` dispatch key only, each
functional collective and ``shard_dim_alltoall`` as a collective of its
own, run synchronously, so ``wait_tensor`` is the identity. Its bytes do
not travel through gloo. Each rank holds one staging buffer of
:data:`STAGING_BYTES` on its card, and every rank maps every other
rank's buffer by CUDA IPC handle (exchanged once, when it is installed,
over the default group). A collective moves a chunk of at most that
many bytes a rank at a time: each rank copies its chunk into its own
buffer, the group meets at a gloo barrier, each rank reads what it needs
from the buffers of the group (a reduction combines them in the group's
rank order, so every rank gets the same bits), and a second barrier
frees the buffers for the next chunk. gloo's own CUDA path stages each
collective through pinned host buffers and TCP: on an H100 host (NVIDIA
H100 80GB HBM3, 700.00 W) an all-gather of 64 MiB a rank over four ranks
took 0.55 s that way, 0.97 s with the pinned staging handed back after
each collective, as this module had to do so that four ranks' caches did
not fill the host (``scripts/torch/gloo_staging.py``).

``avg`` is the sum divided by the group's size. A reduction it does not
know raises. It is installed only by
:func:`repro_torch.launch.mesh.make_device_mesh` on a ``cuda`` mesh over
a ``gloo`` group, and only once a process; every rank must be on one
host. The tests install it for the ``CPU`` key, where the buffers are
files the ranks map shared.
"""

from __future__ import annotations

import gc
import math
import os
import socket
import tempfile
from typing import List

import torch
import torch.distributed as dist

_LIB = None
_STAGE = None

#: bytes of each rank's staging buffer: a collective that moves more a
#: rank moves in chunks of this many
STAGING_BYTES = 64 << 20

_COMBINE = {
    "sum": torch.Tensor.add_, "avg": torch.Tensor.add_,
    "product": torch.Tensor.mul_,
    "min": lambda d, s: torch.minimum(d, s, out=d),
    "max": lambda d, s: torch.maximum(d, s, out=d)}


class _Staging:
    """This rank's staging buffer (``mine``) and every rank's (``bufs``,
    by global rank, this rank's own among them), all mapped in this
    process; on a ``CPU`` key shared files, on ``CUDA`` memory on the
    card."""

    def __init__(self, device_type: str, nbytes: int):
        rank = dist.get_rank()
        self.nbytes = nbytes
        self.cuda = device_type.upper() == "CUDA"
        if self.cuda:
            from torch.multiprocessing.reductions import reduce_tensor
            mine = torch.empty(nbytes, dtype=torch.uint8, device=torch.device(
                "cuda", torch.cuda.current_device()))
            # a handle for each other rank: each counts once against the
            # buffer's IPC reference count, and drops once
            share = [None if r == rank else reduce_tensor(mine)
                     for r in range(dist.get_world_size())]
        else:
            fd, share = tempfile.mkstemp(prefix=f"staging{rank}_")
            os.close(fd)
            mine = torch.from_file(share, shared=True, size=nbytes,
                                   dtype=torch.uint8)
        got = [None] * dist.get_world_size()
        dist.all_gather_object(got, (socket.gethostname(), share))
        hosts = sorted({h for h, _s in got})
        if len(hosts) != 1:
            raise RuntimeError(f"gloo_cuda's staging needs every rank on "
                               f"one host, the ranks are on {hosts}")
        self.mine = mine
        self.bufs = [mine if r == rank else
                     s[rank][0](*s[rank][1]) if self.cuda else
                     torch.from_file(s, shared=True, size=nbytes,
                                     dtype=torch.uint8)
                     for r, (_h, s) in enumerate(got)]
        if not self.cuda:
            dist.barrier()  # every rank has mapped every file
            os.unlink(share)
        self._groups = {}

    def group(self, group_name: str) -> tuple:
        """``(process group, this rank's index in it, the group's
        buffers in its rank order)``."""
        if group_name not in self._groups:
            from torch.distributed.distributed_c10d import \
                _resolve_process_group
            g = _resolve_process_group(group_name)
            ranks = dist.get_process_group_ranks(g)
            self._groups[group_name] = (g, ranks.index(dist.get_rank()),
                                        [self.bufs[r] for r in ranks])
        return self._groups[group_name]

    def meet(self, g) -> None:
        """This rank's copies done, then the group's barrier."""
        if self.cuda:
            torch.cuda.current_stream().synchronize()
        dist.barrier(group=g)


def _chunks(n: int, per: int):
    return ((a, min(a + per, n)) for a in range(0, n, per))


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's bytes, flat."""
    return t.reshape(-1).view(torch.uint8)


def _finish(out: torch.Tensor, reduce_op: str, n: int) -> torch.Tensor:
    return out.div_(n) if reduce_op.lower() == "avg" else out


def _combine(reduce_op: str):
    if reduce_op.lower() not in _COMBINE:
        raise NotImplementedError(f"no {reduce_op!r} reduction")
    return _COMBINE[reduce_op.lower()]


def _reduce(dst: torch.Tensor, parts: list, op) -> None:
    dst.copy_(parts[0])
    for p in parts[1:]:
        op(dst, p)


def all_gather_into_tensor(inp, group_size, group_name):
    g, _me, bufs = _STAGE.group(group_name)
    out = inp.new_empty((inp.shape[0] * group_size,) + tuple(inp.shape[1:]))
    src = _bytes(inp.contiguous())
    dst = _bytes(out).view(group_size, src.numel())
    for a, b in _chunks(src.numel(), _STAGE.nbytes):
        _STAGE.mine[:b - a].copy_(src[a:b])
        _STAGE.meet(g)
        for j, buf in enumerate(bufs):
            dst[j, a:b].copy_(buf[:b - a])
        _STAGE.meet(g)
    return out


def all_reduce(inp, reduce_op, group_name):
    g, _me, bufs = _STAGE.group(group_name)
    op = _combine(reduce_op)
    out = inp.clone(memory_format=torch.contiguous_format)
    flat = out.view(-1)
    parts = [b.view(flat.dtype) for b in bufs]
    per = _STAGE.nbytes // flat.element_size()
    for a, b in _chunks(flat.numel(), per):
        _STAGE.mine.view(flat.dtype)[:b - a].copy_(flat[a:b])
        _STAGE.meet(g)
        _reduce(flat[a:b], [p[:b - a] for p in parts], op)
        _STAGE.meet(g)
    return _finish(out, reduce_op, len(bufs))


def reduce_scatter_tensor(inp, reduce_op, group_size, group_name):
    g, me, bufs = _STAGE.group(group_name)
    op = _combine(reduce_op)
    out = inp.new_empty((inp.shape[0] // group_size,) + tuple(inp.shape[1:]))
    src = inp.contiguous().view(group_size, out.numel())
    flat = out.view(-1)
    parts = [b.view(flat.dtype) for b in bufs]
    per = _STAGE.nbytes // (flat.element_size() * group_size)
    for a, b in _chunks(flat.numel(), per):
        k = b - a
        _STAGE.mine.view(flat.dtype)[:group_size * k] \
            .view(group_size, k).copy_(src[:, a:b])
        _STAGE.meet(g)
        _reduce(flat[a:b], [p[me * k:(me + 1) * k] for p in parts], op)
        _STAGE.meet(g)
    return _finish(out, reduce_op, group_size)


def _exchange(g, me: int, bufs: list, src, dst, sends: list) -> None:
    """All-to-all of bytes: ``sends[j][k]`` bytes go from rank ``j`` of
    the group to rank ``k``, in rank order in ``j``'s ``src``; this rank
    lays what it takes from each in rank order in ``dst``. Every rank
    stages the same windows of its ``src`` in turn."""
    starts = [[sum(row[:k]) for k in range(len(row))] for row in sends]
    at = 0
    takes = []
    for j, row in enumerate(sends):
        takes.append((starts[j][me], starts[j][me] + row[me], at))
        at += row[me]
    for w0, w1 in _chunks(max(sum(row) for row in sends), _STAGE.nbytes):
        if w0 < src.numel():
            _STAGE.mine[:min(w1, src.numel()) - w0].copy_(src[w0:w1])
        _STAGE.meet(g)
        for buf, (s, e, o) in zip(bufs, takes):
            lo, hi = max(s, w0), min(e, w1)
            if lo < hi:
                dst[o + lo - s:o + hi - s].copy_(buf[lo - w0:hi - w0])
        _STAGE.meet(g)


def all_to_all_single(inp, output_split_sizes, input_split_sizes,
                      group_name):
    g, me, bufs = _STAGE.group(group_name)
    n = len(bufs)
    inp = inp.contiguous()
    row = inp.element_size() * math.prod(inp.shape[1:])
    outs = list(output_split_sizes) or [inp.shape[0] // n] * n
    out = inp.new_empty((sum(outs),) + tuple(inp.shape[1:]))
    if input_split_sizes:
        # every rank's splits: where in its input each rank's block starts
        table = all_gather_into_tensor(torch.tensor(
            list(input_split_sizes), dtype=torch.int64, device=inp.device),
            n, group_name).view(n, n).tolist()
    else:
        table = [[inp.shape[0] // n] * n] * n
    _exchange(g, me, bufs, _bytes(inp), _bytes(out),
              [[s * row for s in r] for r in table])
    return out


def broadcast(inp, src, group_name):
    g, me, bufs = _STAGE.group(group_name)
    out = inp.clone(memory_format=torch.contiguous_format)
    flat = _bytes(out)
    for a, b in _chunks(flat.numel(), _STAGE.nbytes):
        if me == src:
            bufs[src][:b - a].copy_(flat[a:b])
        _STAGE.meet(g)
        if me != src:
            flat[a:b].copy_(bufs[src][:b - a])
        _STAGE.meet(g)
    return out


def all_gather_into_tensor_coalesced(inputs, group_size, group_name
                                     ) -> List[torch.Tensor]:
    return [all_gather_into_tensor(t, group_size, group_name)
            for t in inputs]


def all_reduce_coalesced(inputs, reduce_op, group_name
                         ) -> List[torch.Tensor]:
    return [all_reduce(t, reduce_op, group_name) for t in inputs]


def reduce_scatter_tensor_coalesced(inputs, reduce_op, group_size,
                                    group_name) -> List[torch.Tensor]:
    return [reduce_scatter_tensor(t, reduce_op, group_size, group_name)
            for t in inputs]


def wait_tensor(t):
    return t  # every collective above has completed when it returns


def shard_dim_alltoall(inp, gather_dim, shard_dim, group_name):
    """``DTensor``'s move of a split from one dimension to another
    (``Shard(gather_dim)`` to ``Shard(shard_dim)`` over one mesh
    dimension, Ulysses' exchange of sequence for heads): ``inp`` cut into
    the group's size of equal blocks along ``shard_dim``, block ``i`` sent
    to rank ``i``, the blocks received concatenated along
    ``gather_dim``, as PyTorch's own computes it; this one through
    :func:`all_to_all_single` on the blocks moved to the front."""
    n = len(_STAGE.group(group_name)[2])
    blocks = inp.movedim(shard_dim, 0)
    blocks = blocks.reshape((n, blocks.shape[0] // n)
                            + tuple(blocks.shape[1:])).contiguous()
    out = all_to_all_single(blocks, [], [], group_name)
    # out[i]: rank i's block of this rank's part of ``shard_dim``
    out = torch.cat(list(out.movedim(1, shard_dim + 1)), dim=gather_dim)
    return out.contiguous()


def release() -> None:
    """This rank's mappings of the other ranks' staging buffers dropped,
    then the default group's barrier: a rank that exits after it leaves
    no mapping of its buffer in another (CUDA warns of one at exit).
    Every rank calls it, or none; no collective runs after it."""
    global _STAGE
    if _STAGE is None:
        return
    _STAGE = None
    gc.collect()
    dist.barrier()


_IMPLS = (all_gather_into_tensor, reduce_scatter_tensor, all_reduce,
          all_to_all_single, broadcast, all_gather_into_tensor_coalesced,
          all_reduce_coalesced, reduce_scatter_tensor_coalesced, wait_tensor)


def install(device_type: str = "CUDA") -> None:
    """Register the collectives above for ``device_type`` (``CUDA``; the
    CPU tests register them for ``CPU`` to check them against gloo's
    native path) in this process, after the ranks share their staging
    buffers: a collective over the default group, which every rank
    calls; a second call does nothing."""
    global _LIB, _STAGE
    if _LIB is not None:
        return
    import torch.distributed._functional_collectives  # noqa: F401 — ops
    _STAGE = _Staging(device_type, STAGING_BYTES)
    lib = torch.library.Library("_c10d_functional", "IMPL")
    for fn in _IMPLS:
        lib.impl(fn.__name__, fn, device_type)
    dlib = torch.library.Library("_dtensor", "IMPL")
    dlib.impl("shard_dim_alltoall", shard_dim_alltoall, device_type)
    _LIB = (lib, dlib)
