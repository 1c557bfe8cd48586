"""DTensor's collectives on CUDA tensors under a ``gloo`` group.

Several ranks on one card cannot share an NCCL group (NCCL refuses two
ranks on one GPU: "Duplicate GPU detected"), so the port's ranks on a
one-card host meet over ``gloo``, which takes CUDA tensors. ``DTensor``
redistributes through PyTorch's functional collectives
(``torch.ops._c10d_functional``): on the H100 host's PyTorch 2.11 every
rank dies with SIGSEGV in ``wait_tensor`` after a functional
``all_gather_into_tensor`` of a CUDA tensor under gloo, while gloo's own
collectives through ``torch.distributed`` (``all_gather_into_tensor``,
``reduce_scatter_tensor``, ``all_reduce``, ``all_to_all_single``,
``broadcast``, in fp32 and bf16) all work there.

:func:`install` registers, for the ``CUDA`` dispatch key only, each
functional collective as that same gloo collective through
``torch.distributed``, run synchronously, so ``wait_tensor`` is the
identity on CUDA tensors. The tensors stay on the card; gloo stages them
through the host itself, in pinned buffers that PyTorch's host allocator
keeps for reuse once they are free. Ranks that share one card's host
would each keep every size they met (on the H100's host, 14 GiB a rank
after a gradient pass of llama3.2-1b over 2 x 2,304 tokens on a (2, 2)
mesh, most of the host's 96 GiB over four ranks), so a collective of
:data:`RELEASE_BYTES` or more hands its staging back once it is done.
``avg`` (which gloo lacks) is the sum divided by the group's size. A
reduction gloo has not got raises. It is installed only by
:func:`repro_torch.launch.mesh.make_device_mesh` on a ``cuda`` mesh
over a ``gloo`` group, and only once a process.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist

_LIB = None

#: a collective that moves this many bytes or more hands gloo's pinned
#: staging back to the system when it is done
RELEASE_BYTES = 64 << 20


def _group(group_name):
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(group_name)


def _op(reduce_op: str):
    ops = {"sum": dist.ReduceOp.SUM, "avg": dist.ReduceOp.SUM,
           "product": dist.ReduceOp.PRODUCT, "min": dist.ReduceOp.MIN,
           "max": dist.ReduceOp.MAX}
    if reduce_op.lower() not in ops:
        raise NotImplementedError(f"gloo has no {reduce_op!r} reduction")
    return ops[reduce_op.lower()]


def _finish(out: torch.Tensor, reduce_op: str, n: int) -> torch.Tensor:
    return out.div_(n) if reduce_op.lower() == "avg" else out


def _release(inp: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``out``, after gloo's staging of a collective from ``inp`` to
    ``out`` went back to the system when it was large: the card's copies
    out of the pinned buffers finish first, so the buffers are free."""
    if out.is_cuda and (inp.numel() * inp.element_size()
                        + out.numel() * out.element_size()) >= RELEASE_BYTES:
        torch.cuda.current_stream(out.device).synchronize()
        torch._C._host_emptyCache()
    return out


def all_gather_into_tensor(inp, group_size, group_name):
    out = inp.new_empty((inp.shape[0] * group_size,) + tuple(inp.shape[1:]))
    dist.all_gather_into_tensor(out, inp.contiguous(), group=_group(group_name))
    return _release(inp, out)


def reduce_scatter_tensor(inp, reduce_op, group_size, group_name):
    out = inp.new_empty((inp.shape[0] // group_size,) + tuple(inp.shape[1:]))
    dist.reduce_scatter_tensor(out, inp.contiguous(), op=_op(reduce_op),
                               group=_group(group_name))
    return _release(inp, _finish(out, reduce_op, group_size))


def all_reduce(inp, reduce_op, group_name):
    g = _group(group_name)
    out = inp.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=_op(reduce_op), group=g)
    return _release(inp, _finish(out, reduce_op, dist.get_world_size(g)))


def all_to_all_single(inp, output_split_sizes, input_split_sizes,
                      group_name):
    rows = sum(output_split_sizes) if output_split_sizes \
        else inp.shape[0]
    out = inp.new_empty((rows,) + tuple(inp.shape[1:]))
    dist.all_to_all_single(out, inp.contiguous(),
                           list(output_split_sizes) or None,
                           list(input_split_sizes) or None,
                           group=_group(group_name))
    return _release(inp, out)


def broadcast(inp, src, group_name):
    out = inp.clone(memory_format=torch.contiguous_format)
    dist.broadcast(out, group_src=src, group=_group(group_name))
    return _release(inp, out)


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


_IMPLS = (all_gather_into_tensor, reduce_scatter_tensor, all_reduce,
          all_to_all_single, broadcast, all_gather_into_tensor_coalesced,
          all_reduce_coalesced, reduce_scatter_tensor_coalesced, wait_tensor)


def install(device_type: str = "CUDA") -> None:
    """Register the collectives above for ``device_type`` (``CUDA``; the
    CPU tests register them for ``CPU`` to check them against gloo's
    native path) in this process; a second call does nothing."""
    global _LIB
    if _LIB is not None:
        return
    import torch.distributed._functional_collectives  # noqa: F401 — ops
    lib = torch.library.Library("_c10d_functional", "IMPL")
    for fn in _IMPLS:
        lib.impl(fn.__name__, fn, device_type)
    _LIB = lib
