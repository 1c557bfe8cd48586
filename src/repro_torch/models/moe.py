"""Mixture-of-Experts FFN with capacity-based dispatch, GShard-style (port
of ``repro/models/moe.py``).

Tokens are split into groups of ``cfg.moe_group_size``; within a group a
top-k router assigns each token to experts up to a capacity ``C =
ceil(group * top_k * capacity_factor / E)``, in token order. Dispatch and
combine are dense one-hot products, as in the reference, whose expert
products run in XLA outside any Pallas kernel: here they are
``torch.einsum`` calls. The router, its softmax and the Switch-style
load-balance loss are fp32; the expert products run in the input dtype.

``jax.lax.top_k`` breaks ties toward the lower expert index; so does the
stable descending sort that :func:`route` takes the top k from
(``torch.topk`` on a card promises no order among equal values).

Under an active mesh the reference's three constraints apply (the groups
over the batch axes, the expert inputs and outputs over ``model``), and
the router runs on each rank's local groups (:func:`_route_on_local_groups`):
routing is per group by construction, and ``DTensor`` has no sharding
rule for its sort, one-hots and cumsum.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.sharding import context as shctx
from repro_torch.sharding.context import constrain

from . import layers


def capacity(cfg, group: int) -> int:
    c = math.ceil(group * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(c, 1)


def route(cfg, p: Dict[str, torch.Tensor], x_grouped: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x_grouped: (G, S, d) -> dispatch (G, S, E, C), combine (G, S, E,
    C), aux loss; all fp32."""
    G, S, _d = x_grouped.shape
    E, K = cfg.n_experts, cfg.top_k
    C = capacity(cfg, S)
    f32 = torch.float32
    logits = x_grouped.to(f32) @ p["router"]                    # (G, S, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, topk_idx = torch.sort(probs, dim=-1, descending=True,
                                     stable=True)
    gate_vals, topk_idx = gate_vals[..., :K], topk_idx[..., :K]  # (G,S,K)
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
    one_hot = torch.nn.functional.one_hot
    # expert assignment one-hots: (G, S, K, E)
    assign = one_hot(topk_idx, E).to(f32)
    # position of each (token, k) within its expert's queue
    flat = assign.reshape(G, S * K, E)
    pos_in_expert = (torch.cumsum(flat, dim=1) - flat).reshape(G, S, K, E)
    assign = assign * (pos_in_expert < C)
    pos = torch.einsum("gske->gsk", pos_in_expert * assign).long()
    cap_onehot = one_hot(pos, C).to(f32)                        # (G,S,K,C)
    disp = torch.einsum("gske,gskc->gsec", assign, cap_onehot)
    comb = torch.einsum("gske,gskc,gsk->gsec", assign, cap_onehot,
                        gate_vals)
    # Switch-style load-balance auxiliary loss
    density = assign.sum(2).mean(1)                             # (G, E)
    router_prob = probs.mean(1)                                 # (G, E)
    aux = (density * router_prob).sum(-1).mean() * (E ** 2) / K
    return disp, comb, aux


def apply_moe(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> ``(out, aux_loss)``; the shared expert (a gated FFN)
    added where the config has one."""
    B, S, d = x.shape
    tokens = B * S
    gs = min(cfg.moe_group_size, tokens)
    G = max(tokens // gs, 1)
    gs = tokens // G
    xg = x.reshape(G, gs, d)
    xg = constrain(xg, (layers.BATCH, None, None))   # reference moe.py:86
    if shctx.is_dtensor(xg):
        disp, comb, aux = _route_on_local_groups(cfg, p, xg)
    else:
        disp, comb, aux = route(cfg, p, xg)
    dt = x.dtype
    expert_in = torch.einsum("gsec,gsd->egcd", disp.to(dt), xg)
    expert_in = constrain(expert_in, ("model", layers.BATCH, None, None))
    h = torch.einsum("egcd,edf->egcf", expert_in, p["w_gate"])
    u = torch.einsum("egcd,edf->egcf", expert_in, p["w_up"])
    if cfg.act == "gelu":
        h = torch.nn.functional.gelu(h, approximate="tanh") * u
    else:
        h = torch.nn.functional.silu(h) * u
    expert_out = torch.einsum("egcf,efd->egcd", h, p["w_down"])
    expert_out = constrain(expert_out, ("model", layers.BATCH, None, None))
    out = torch.einsum("gsec,egcd->gsd", comb.to(dt), expert_out)
    out = out.reshape(B, S, d)
    if cfg.shared_expert:
        out = out + layers.apply_ffn(cfg, p["shared"], x)
    return out, aux.to(torch.float32)


def _route_on_local_groups(cfg, p: Dict[str, torch.Tensor],
                           xg: torch.Tensor):
    """:func:`route` on each rank's local groups of a ``DTensor`` ``xg``
    (G, S, d), by ``local_map``: the groups over the batch axes when they
    divide (else every rank routes them all), the router whole. The aux
    loss is the mean over groups, so the local means come back as a
    ``Partial("avg")`` over the axes the groups are split on."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.sharding.partition import placements_for
    mesh = shctx.active_mesh()
    spec = shctx._divisible(
        shctx._resolve((layers.BATCH, None, None), mesh) or (None,) * 3,
        xg.shape, mesh)
    axes = spec[0] if isinstance(spec[0], tuple) else \
        (() if spec[0] is None else (spec[0],))
    pin = list(placements_for(spec, mesh))
    prep = list(placements_for((None, None), mesh))
    pout = list(placements_for(spec + (None,), mesh))
    paux = [Partial("avg") if a in axes else Replicate()
            for a in shctx.axis_names(mesh)]

    def local(router, x):
        return route(cfg, {"router": router}, x)
    return local_map(local, out_placements=(pout, pout, paux),
                     in_placements=(prep, pin), device_mesh=mesh,
                     redistribute_inputs=True)(p["router"], xg)
