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
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from repro_torch.core.tree import leaves, map_leaves


class AdamWConfig(NamedTuple):
    lr: float = 1e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def init_opt_state(params) -> Dict[str, Any]:
    """master: fp32 copy; m/v: fp32 zeros; a 0-d int32 step counter on the
    params' device."""
    flat = leaves(params)
    device = flat[0].device if flat else torch.device("cpu")
    return {
        "master": map_leaves(lambda x: x.detach().to(torch.float32,
                                                     copy=True), params),
        "m": map_leaves(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                              device=x.device), params),
        "v": map_leaves(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                              device=x.device), params),
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


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
        g = g.to(torch.float32) * scale
        m.mul_(hp.b1).add_((1 - hp.b1) * g)
        v.mul_(hp.b2).add_((1 - hp.b2) * torch.square(g))
        mhat = m / b1c
        vhat = v / b2c
        w.sub_(hp.lr * (mhat / (torch.sqrt(vhat) + hp.eps)
                        + hp.weight_decay * w))
        p.copy_(w)
