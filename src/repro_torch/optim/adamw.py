"""AdamW with fp32 master weights (port of ``repro/optim/adamw.py``).

The training state mirrors the paper's DeepSpeed/ZeRO-1 composition
(Table I): bf16 working params (the "model state") plus fp32 master
copies, momentum and variance (the "optimizer state", about 4x the model
bytes and the bulk of every checkpoint).

:func:`apply_updates` updates **in place**. JAX returns new arrays; here
the step overwrites ``master``, ``m``, ``v``, ``count`` and the params, so
no second copy of the 4x-sized optimizer state is ever allocated. That is
exactly the hazard the lazy checkpoint protocol guards against: a save's
device-to-host copies read these buffers, so the caller runs
``CheckpointManager.wait_for_capture()`` before every update that follows
a save.

On ``DTensor`` state (the sharded train step, under an active mesh) the
update runs on each leaf's layout: where the optimizer state is sharded
differently from the params (``tp_zero1``: ``master``, ``m`` and ``v``
split over ``data`` where the params are not), the gradient is
redistributed to the optimizer state's layout and the new master copy to
the param's, explicitly, as XLA inserts those moves.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from repro_torch.core.tree import leaves, map_leaves
from repro_torch.sharding.context import is_dtensor


class AdamWConfig(NamedTuple):
    lr: float = 1e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def init_opt_state(params) -> Dict[str, Any]:
    """master: fp32 copy; m/v: fp32 zeros (each in its param's layout);
    a 0-d int32 step counter on the params' device (replicated on their
    mesh for ``DTensor`` params)."""
    flat = leaves(params)
    device = flat[0].device if flat else torch.device("cpu")
    count = torch.zeros((), dtype=torch.int32, device=device)
    if flat and is_dtensor(flat[0]):
        from torch.distributed.tensor import DTensor, Replicate
        mesh = flat[0].device_mesh
        count = DTensor.from_local(count, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
    return {
        "master": map_leaves(lambda x: x.detach().to(torch.float32,
                                                     copy=True), params),
        "m": map_leaves(lambda x: torch.zeros_like(
            x, dtype=torch.float32, memory_format=torch.contiguous_format),
            params),
        "v": map_leaves(lambda x: torch.zeros_like(
            x, dtype=torch.float32, memory_format=torch.contiguous_format),
            params),
        "count": count,
    }


def _like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``x`` in ``ref``'s layout (a ``DTensor`` redistributed to ``ref``'s
    placements; a plain tensor as it is)."""
    if is_dtensor(ref) and x.placements != ref.placements:
        return x.redistribute(ref.device_mesh, ref.placements)
    return x


def global_norm(tree) -> torch.Tensor:
    sq = [torch.sum(torch.square(g.to(torch.float32))) for g in leaves(tree)]
    return torch.sqrt(torch.stack(sq).sum())


@torch.no_grad()
def apply_updates(params, opt_state: Dict[str, Any], grads,
                  hp: AdamWConfig) -> None:
    """One AdamW step, in place, with the JAX package's arithmetic."""
    opt_state["count"].add_(1)
    count = opt_state["count"].to(torch.float32)
    gn = global_norm(grads)
    scale = torch.clamp(hp.grad_clip / (gn + 1e-9), max=1.0)
    b1c = 1.0 - torch.pow(torch.tensor(hp.b1, device=count.device), count)
    b2c = 1.0 - torch.pow(torch.tensor(hp.b2, device=count.device), count)
    for g, m, v, w, p in zip(leaves(grads), leaves(opt_state["m"]),
                             leaves(opt_state["v"]),
                             leaves(opt_state["master"]), leaves(params)):
        g = _like(g.to(torch.float32) * scale, m)
        m.mul_(hp.b1).add_((1 - hp.b1) * g)
        v.mul_(hp.b2).add_((1 - hp.b2) * torch.square(g))
        mhat = m / b1c
        vhat = v / b2c
        w.sub_(hp.lr * (mhat / (torch.sqrt(vhat) + hp.eps)
                        + hp.weight_decay * w))
        if is_dtensor(p) and w.placements != p.placements:
            # ZeRO-1: the updated params gathered over ``data`` in their
            # own dtype, not the fp32 master (the cast is the same either
            # side of the gather)
            w = w.to(p.dtype)
        p.copy_(_like(w, p))
